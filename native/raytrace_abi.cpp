// C ABI embedding library — signature-compatible with the reference's
// exported entry point (/root/reference/src/ray_trace.h:9-15): a host
// application links (or dlopens/ctypes-loads) libraytrace.so and calls
// ray_trace(samples, storeRenderResult, width, height, gpu_count), exactly
// like the reference's scripts/test.py smoke test does against its
// ray_trace.dll.
//
// The renderer itself is the JAX/Pallas framework, so this library
// embeds CPython and forwards to raytrace_tpu.api.ray_trace.  The embedded
// interpreter is initialized once and reused across calls.
//
// Build: make -C native   (produces build/libraytrace.so)

#include <Python.h>

#include <cstdint>
#include <cstdio>

extern "C"
#if defined(_WIN32)
__declspec(dllexport)
#endif
void ray_trace(uint32_t samples = 10, bool storeRenderResult = false,
               uint32_t width = 1920, uint32_t height = 1080,
               uint32_t gpu_count = 1) {
    const bool owned = !Py_IsInitialized();
    if (owned) Py_InitializeEx(0);
    PyGILState_STATE gil = PyGILState_Ensure();

    PyObject* mod = PyImport_ImportModule("raytrace_tpu");
    if (!mod) {
        PyErr_Print();
        std::fprintf(stderr, "raytrace_tpu import failed\n");
        PyGILState_Release(gil);
        return;
    }
    PyObject* fn = PyObject_GetAttrString(mod, "ray_trace");
    Py_DECREF(mod);
    if (!fn) {
        PyErr_Print();
        PyGILState_Release(gil);
        return;
    }
    PyObject* args = Py_BuildValue(
        "(IOIII)", samples, storeRenderResult ? Py_True : Py_False, width,
        height, gpu_count);
    PyObject* res = PyObject_CallObject(fn, args);
    if (!res) PyErr_Print();
    Py_XDECREF(res);
    Py_XDECREF(args);
    Py_DECREF(fn);
    PyGILState_Release(gil);
    // the interpreter stays alive for subsequent calls (finalizing JAX's
    // runtime mid-process is not supported)
}

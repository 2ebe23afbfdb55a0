/* Thin native executable linking the shared library — the analogue of the
 * reference's RayTracingGPUVulkan exe (/root/reference/src/main.cpp:10-64
 * linked against the ray_trace shared lib, CMakeLists.txt:47-51).  Same
 * flags, same defaults, same unknown-argument behavior (warn on stderr and
 * continue).
 *
 * Build: make -C native   (produces build/raytrace_demo; rpath $ORIGIN so
 *        no LD_LIBRARY_PATH is needed)
 * Run:   PYTHONPATH=<repo root> native/build/raytrace_demo --samples 4
 *        (PYTHONPATH unnecessary when raytrace_tpu is pip-installed — the
 *        embedded interpreter imports it like any package)
 */

#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* the shared library's exported entry point (native/raytrace_abi.cpp,
 * signature-compatible with /root/reference/src/ray_trace.h:9-15) */
extern void ray_trace(uint32_t samples, bool storeRenderResult,
                      uint32_t width, uint32_t height, uint32_t gpu_count);

int main(int argc, char** argv) {
    uint32_t samples = 10, width = 1920, height = 1080, gpus = 1;
    bool store = false;
    for (int i = 1; i < argc; i++) {
        const char* a = argv[i];
        if (strcmp(a, "--help") == 0) {
            /* reference main.cpp:21-27 help block (incl. its typo) */
            printf("--help                # Show this help infomation\n"
                   "--store               # Store rendered image to file\n"
                   "--samples <count>     # Total samples to render\n"
                   "--width <width>       # Image width\n"
                   "--height <height>     # Image height\n"
                   "--gpus <count>        # Max used devices count\n");
            return 0;
        } else if (strcmp(a, "--store") == 0) {
            store = true;
        } else if (strcmp(a, "--samples") == 0 && i + 1 < argc) {
            samples = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else if (strcmp(a, "--width") == 0 && i + 1 < argc) {
            width = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else if (strcmp(a, "--height") == 0 && i + 1 < argc) {
            height = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else if (strcmp(a, "--gpus") == 0 && i + 1 < argc) {
            gpus = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else {
            fprintf(stderr, "unknown argument: %s\n", a); /* main.cpp:49 */
        }
    }
    ray_trace(samples, store, width, height, gpus);
    return 0;
}

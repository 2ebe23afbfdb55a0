"""Grid-DDA wavefront as one Pallas-Triton kernel — the GPU hot path.

As a plain XLA while loop, each wavefront iteration of the grid march is
a chain of XLA kernels: all lane state (~27 values per lane) goes through
device memory between them, and the loop predicate returns to the host
every iteration.  A DDA march has data-dependent trip counts and small
gathers, so those fixed costs dwarf its arithmetic (that loop took 18x
this kernel's time on an H100 and was removed; PERF.md).

Here one program owns a power-of-two block of lanes, one lane per thread,
and runs the whole band for them: its lanes' state lives in registers from
the first camera ray to the last flush, and the loop ends when the last
lane of the block has rendered all its pixels.  Per iteration every lane
that needs a new segment tests the global spheres and enters the grid, the
block marches until none of its lanes is marching (each cell's candidates
are gathered from the flat tables of models/grid.py, which stay in L2), and
then the lanes shade, scatter and regenerate.  A pixel's colour sum is
written to the accumulator in device memory once, when its lane moves on
to the next pixel.  The per-lane arithmetic is ops/wavefront.py, the same
code the XLA backends run, so the kernel differs from ``bruteforce`` only
in the closest-hit search and in rounding (below).

Numerics: Triton lowers f32 ``/`` to the approximate ``div.full.f32``, so
the compiled kernel divides with ``div.rn.f32`` (IEEE round-to-nearest,
like XLA).  Triton and XLA:GPU both contract multiply-adds into FMAs, in
different places, so the compiled kernel matches ``bruteforce`` on the card
statistically, not bitwise; in interpret mode (tests) it is the same jnp
code as ``bruteforce`` and matches it bitwise.
"""

from __future__ import annotations

import functools
import operator

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from . import wavefront as wf

BLOCK = 128  # lanes per program (one per thread: 4 warps)


def block_lanes(n_lanes: int, block: int = BLOCK) -> int:
    """Lanes per program: ``block``, or the next power of two >= n_lanes
    for bands smaller than one block (Triton blocks are powers of two; a
    warp is 32 threads)."""
    return max(32, min(block, pl.next_power_of_2(n_lanes)))


def ieee_div(a, b):
    """f32 a / b rounded to nearest, as one PTX ``div.rn.f32``."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    if not shape:
        return a / b
    [q] = plt.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[jnp.broadcast_to(a, shape), jnp.broadcast_to(b, shape)],
        constraints="=r,r,r", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(shape, jnp.float32)])
    return q


def _kernel(scal, vpr, gscal, gtab, cellf, cellid, cellcnt, atab, acc_in,
            acc, iters, *, block, n_lanes, m_slots, p_total, width,
            max_depth, rr, div, spare):
    pid = pl.program_id(0)
    lane = pid * block + jnp.arange(block, dtype=jnp.int32)
    alive0 = (lane < n_lanes) & (scal[wf.S_SPP] > 0)
    st0 = wf.init_lanes(lane, alive0, scal, vpr, width, div)

    def body(c):
        st, it = c
        t, idx, hit, done, st = wf.grid_hit(st, gtab, cellf, cellid, cellcnt,
                                            gscal, div=div)
        st, flush, pix, cur = wf.step(
            st, lane, t, idx, hit, done, scal=scal, vpr=vpr, atab=atab,
            m_slots=m_slots, n_lanes=n_lanes, p_total=p_total, width=width,
            max_depth=max_depth, rr=rr, div=div, gate_reseed=True)
        # the last block's padding lanes never flush, and compiled masked
        # stores write nothing; the interpreter writes masked lanes back,
        # so there they go to spare columns instead of aliasing live pixels
        addr = pix
        if spare:
            addr = jnp.where(lane < n_lanes, pix, p_total + lane % block)
        for ch in range(3):
            old = plt.load(acc_in.at[ch, addr], mask=flush, other=0.0)
            plt.store(acc.at[ch, addr], old + cur[ch], mask=flush)
        return st, it + 1

    _, it = jax.lax.while_loop(lambda c: jnp.max(c[0].alive) > 0, body,
                               (st0, jnp.int32(0)))
    iters[pid] = it


def render_lanes(grid, atab, scal, vpr, acc, *, n_lanes, m_slots, p_total,
                 width, max_depth, rr, block=BLOCK, interpret=False):
    """Run the band's ``n_lanes`` lanes to completion.

    ``acc``: f32 [3, p_total] accumulator (flushed pixels add their colour
    sums in place).  Returns (acc, iters) with the loop iteration count of
    every program.  ``interpret`` runs the kernel in the Pallas interpreter
    with plain division (tests; the inline-PTX division exists only
    compiled) and ``block`` spare accumulator columns for padding lanes.
    """
    block = block_lanes(n_lanes, block)
    n_blocks = -(-n_lanes // block)
    spare = block if interpret else 0
    if spare:
        acc = jnp.pad(acc, ((0, 0), (0, spare)))
    kernel = functools.partial(
        _kernel, block=block, n_lanes=n_lanes, m_slots=m_slots,
        p_total=p_total, width=width, max_depth=max_depth, rr=rr,
        div=operator.truediv if interpret else ieee_div, spare=spare)
    acc, iters = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        out_shape=(jax.ShapeDtypeStruct(acc.shape, jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks,), jnp.int32)),
        input_output_aliases={8: 0},
        compiler_params=plt.CompilerParams(num_warps=block // 32,
                                           num_stages=1),
        backend="triton",
        interpret=interpret,
        name="grid_wavefront",
    )(scal, vpr, grid.gscal, grid.gtab, grid.cellf, grid.cellid,
      grid.cellcnt, atab, acc)
    return (acc[:, :p_total] if spare else acc), iters

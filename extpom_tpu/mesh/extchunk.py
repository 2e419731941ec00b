"""Chunked external-mode loop for shard_map local blocks.

The plain shard_map path issues a ``lax.ppermute`` edge-strip exchange at
EVERY shifted read of every substep (ops/stencil.py ``_halo_shift``) —
~30 narrow latency-bound collectives per external substep, x isplit per
internal step, the same pattern as the reference's per-kernel
exchange2d_mpi calls (parallel_mpi.f:154-239).

This module applies the temporal-tiling trade: once per ``C`` substeps,
exchange ONE halo ring of width ``H = C x ext_halo_sub`` per carry field
(x strips first, then y strips of the already-extended block, so corners
ride along — the same ordering trick the reference's exchange2d relies
on), then run the C
substeps on the halo-extended local block with PLAIN local shifts under a
windowed DomainCtx (global region masks).  Collective count drops from
~isplit x 30 permutes to (isplit/C) x 14 ring exchanges + a one-time
extension of the static fields.

Correctness at physical edges: ppermute non-receivers zero-fill the ring,
matching ``sft``'s zero-fill-beyond-domain semantics, and every substep
update is either put-masked on GLOBAL indices (out-of-domain rows keep
their zero base) or arithmetic on already-zero values (the
padded-window invariant, tests/test_shardmap.py).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from extpom_tpu.core.config import Config
from extpom_tpu.ops import stencil

# forcing fields the external substep reads: 2-D fields, and the 1-D
# open-boundary series of bcond idx 1/2 (bounds_forcing.f:18-83) along j
# (length jm) and along i (length im)
FC_2D_FIELDS = ("wusurf", "wvsurf", "vflux", "e_atmos")
FC_1D_J = ("elw", "ele", "uabw", "uabe", "vabw", "vabe")
FC_1D_I = ("els", "eln", "vabs", "vabn", "uabs", "uabn")


def use_chunked_local(cfg: Config, ctx, local_shape=None) -> bool:
    """Dispatch: chunked halo windows for the shard_map external loop.
    ``local_shape``: the (ni, nj) of one local block (ring width must not
    exceed the neighbor's extent)."""
    if cfg.ext_local_chunk == "off" or ctx is None or not ctx.local:
        return False
    return _chunk(cfg, ctx, local_shape) >= 2


def _chunk(cfg: Config, ctx, local_shape) -> int:
    """Largest divisor C of isplit with ring width C x ext_halo_sub that
    fits the split local extents."""
    if ctx.px <= 1 and ctx.py <= 1:
        # unsplit mesh (shard_map 1x1): local shifts never cross a block
        # boundary, no halo is consumed — the whole loop is one chunk
        return cfg.isplit
    lim = cfg.isplit * cfg.ext_halo_sub
    if local_shape is not None:
        if ctx.px > 1:
            lim = min(lim, local_shape[-2])
        if ctx.py > 1:
            lim = min(lim, local_shape[-1])
    for C in range(min(cfg.extwin_chunk, cfg.isplit), 0, -1):
        if cfg.isplit % C == 0 and C * cfg.ext_halo_sub <= lim:
            return C
    return 1


def _ring_extend(a, ctx, H: int, fill: float = 0.0):
    """Local (.., ni, nj) block -> (.., ni+2Hx, nj+2Hy) with neighbor halo
    rings of width H; Hx/Hy collapse to 0 on un-split axes.

    ``fill`` is the value rings take BEYOND the physical domain (ppermute
    non-receivers).  Prognostic fields use 0.0 — matching ``sft``'s
    zero-fill-beyond-domain semantics exactly (every committed-cell value
    is put-masked on global indices, so out-of-domain rows keep their
    base).  Grid metrics that sit in denominators use 1.0 (the same
    GRID_PAD_ONE rule as mesh.padding): their out-of-domain values only
    feed masked-away expression cells, but a 0 there makes every substep
    compute 0/0 -> NaN intermediates whose silent propagation one
    unmasked expression away — 1.0 keeps all halo arithmetic finite."""
    Hx = H if ctx.px > 1 else 0
    Hy = H if ctx.py > 1 else 0

    def _fill_where_edge(recv, name, first_pos):
        if fill == 0.0:
            return recv
        pos = lax.axis_index(name)
        is_edge = (pos == 0) if first_pos else \
            (pos == (ctx.px if name == ctx.axis_x else ctx.py) - 1)
        return jnp.where(is_edge, jnp.full_like(recv, fill), recv)

    if Hx:
        idx = lambda s: (Ellipsis, s, slice(None))
        lo = lax.ppermute(a[idx(slice(-Hx, None))], ctx.axis_x,
                          [(p, p + 1) for p in range(ctx.px - 1)])
        hi = lax.ppermute(a[idx(slice(0, Hx))], ctx.axis_x,
                          [(p + 1, p) for p in range(ctx.px - 1)])
        lo = _fill_where_edge(lo, ctx.axis_x, True)
        hi = _fill_where_edge(hi, ctx.axis_x, False)
        a = jnp.concatenate([lo, a, hi], axis=-2)
    if Hy:
        idx = lambda s: (Ellipsis, s)
        lo = lax.ppermute(a[idx(slice(-Hy, None))], ctx.axis_y,
                          [(p, p + 1) for p in range(ctx.py - 1)])
        hi = lax.ppermute(a[idx(slice(0, Hy))], ctx.axis_y,
                          [(p + 1, p) for p in range(ctx.py - 1)])
        lo = _fill_where_edge(lo, ctx.axis_y, True)
        hi = _fill_where_edge(hi, ctx.axis_y, False)
        a = jnp.concatenate([lo, a, hi], axis=-1)
    return a


def _ring_extend_1d(a, ctx, H: int, axis: str):
    """Extend a per-side 1-D series ((ni,) along x or (nj,) along y)."""
    n_split = ctx.px if axis == "x" else ctx.py
    name = ctx.axis_x if axis == "x" else ctx.axis_y
    if n_split <= 1:
        return a
    lo = lax.ppermute(a[..., -H:], name,
                      [(p, p + 1) for p in range(n_split - 1)])
    hi = lax.ppermute(a[..., :H], name,
                      [(p + 1, p) for p in range(n_split - 1)])
    return jnp.concatenate([lo, a, hi], axis=-1)


def run_external_loop_chunked(grid, cfg: Config, c0, fc, aux, ctx):
    """Run the isplit external substeps in chunks of C on halo-extended
    local blocks, each chunk an XLA ``fori_loop`` under a windowed
    DomainCtx.  Same contract as the plain external loop; must be called
    inside shard_map local mode (``ctx.local``)."""
    from extpom_tpu.core import stepper
    from extpom_tpu.mesh.padding import _GRID_PAD_ONE

    ni = c0.el.shape[-2]
    nj = c0.el.shape[-1]
    C = _chunk(cfg, ctx, (ni, nj))
    H = C * cfg.ext_halo_sub
    Hx = H if ctx.px > 1 else 0
    Hy = H if ctx.py > 1 else 0
    n_chunks = cfg.isplit // C

    ext = lambda a: _ring_extend(a, ctx, H)
    # static fields: extended once; denominator metrics get 1.0 beyond the
    # physical domain (finite halo arithmetic — the GRID_PAD_ONE rule)
    g_ns = type(grid)(**{  # Grid is a frozen dataclass pytree
        **{f: _ring_extend(getattr(grid, f), ctx, H,
                           fill=(1.0 if f in _GRID_PAD_ONE else 0.0))
           if getattr(grid, f).ndim >= 2
           and getattr(grid, f).shape[-2:] == (ni, nj)
           else getattr(grid, f)
           for f in grid.__dataclass_fields__}})
    aux_e = tuple(ext(a) for a in aux)
    fc_patch = {f: ext(getattr(fc, f)) for f in FC_2D_FIELDS}
    fc_patch.update({f: _ring_extend_1d(
        jnp.asarray(getattr(fc, f), c0.el.dtype), ctx, H, "y")
        for f in FC_1D_J})
    fc_patch.update({f: _ring_extend_1d(
        jnp.asarray(getattr(fc, f), c0.el.dtype), ctx, H, "x")
        for f in FC_1D_I})
    fc_e = fc.replace(**fc_patch)

    # windowed ctx over the extended block: global offsets shift by -H on
    # split axes
    win_ctx = stencil.DomainCtx(
        im=ctx.im, jm=ctx.jm, windowed=True,
        off_i=ctx.off_i - Hx, off_j=ctx.off_j - Hy)

    trim = lambda a: a[..., Hx:Hx + ni, Hy:Hy + nj] if (Hx or Hy) else a

    def chunk(ic, c):
        c = stepper.ExtCarry(*(ext(f) for f in c))
        with stencil.domain(win_ctx), stencil.mask_caching():
            em = stepper.ext_precompute(g_ns)
            # peel the first substep to prime the mask cache
            c = stepper.mode_external_substep(
                g_ns, cfg, c, ic * C + 1, fc_e, aux_e, em=em)

            def body(s, c):
                return stepper.mode_external_substep(
                    g_ns, cfg, c, ic * C + 1 + s, fc_e, aux_e, em=em)
            c = lax.fori_loop(1, C, body, c)
        return stepper.ExtCarry(*(trim(f) for f in c))

    return lax.fori_loop(0, n_chunks, chunk, c0)

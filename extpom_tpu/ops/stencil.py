"""Shifted-slice stencil primitives (SPMD-sound, branch-free).

The reference expresses every horizontal stencil as Fortran loops over
partial index ranges with explicit neighbor indexing (e.g. solver.f:20-34).
Here each op is written on *global* arrays using two primitives:

* :func:`sft` — a zero-padded shifted read: ``sft(a, di, dj)[..., i, j] ==
  a[..., i+di, j+dj]`` (0 outside the array).  Fortran ``a(i-1,j)`` inside a
  loop body is ``sft(a, -1, 0)``.
* :func:`put` — region-limited assignment: evaluate a full-shape expression
  but commit it only on the region the Fortran loop covered, keeping the
  base array's values elsewhere.

``put`` (and the :func:`set_i`/:func:`set_j`/:func:`set_k` edge writers) are
implemented as ``jnp.where`` selects over iota masks, NOT as
``array.at[...].set``: masked selects partition trivially and fuse into the
surrounding elementwise work, whereas scatter/dynamic-update-slice regions
that land entirely inside one shard are miscompiled by the XLA SPMD
partitioner in this environment (observed: global edge-row updates zeroing
the first row of every shard).  This replaces the reference's
exchange2d/3d_mpi (parallel_mpi.f:154-351) and its edge-rank conditionals
(n_west.eq.-1 etc.) wholesale: shifts lower to halo collective-permutes,
masks make every rank execute the same program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass(frozen=True)
class DomainCtx:
    """Horizontal-domain context for the stencil primitives.

    Two orthogonal capabilities, both trace-time:

    * **Active extents** (``im``, ``jm``): arrays may be PADDED beyond the
      physical domain (ragged-decomposition support — the analogue of the
      reference's shrunken edge tiles, parallel_mpi.f:88-105, realized as
      pad-and-mask).  Region bounds, including negative indices, resolve
      against the active extents, so masked writes never touch pad cells
      and ``row``/``col`` address physical rows.
    * **Local (shard_map) mode** (``axis_x``/``axis_y`` set): arrays are
      per-shard LOCAL blocks of a 2-D mesh decomposition.  ``sft`` becomes
      an explicit halo exchange (``lax.ppermute`` of edge strips — the
      exchange2d/3d_mpi analogue, parallel_mpi.f:154-351) and region masks
      use global indices (local iota + block offset).
    """

    im: int                      # active global i extent
    jm: int                      # active global j extent
    axis_x: Optional[str] = None   # mesh axis names (local mode only)
    axis_y: Optional[str] = None
    px: int = 1                  # mesh extent along x / y
    py: int = 1
    off_i: Any = 0               # global row offset of this block (traced)
    off_j: Any = 0
    windowed: bool = False       # arrays are overlapping halo WINDOWS of
                                 # the global domain (mesh.extchunk): region
                                 # masks use global indices, shifts stay
                                 # local (progressive halo invalidation is
                                 # accounted for by the window trim)

    @property
    def local(self) -> bool:
        return self.axis_x is not None or self.axis_y is not None

    @property
    def block(self) -> bool:
        """Arrays are partial views of the domain (local or windowed)."""
        return self.local or self.windowed


_tls = threading.local()


def _ctx() -> Optional[DomainCtx]:
    return getattr(_tls, "domain", None)


def domain_ctx() -> Optional[DomainCtx]:
    """Public accessor for the active :class:`DomainCtx` (or None)."""
    return _ctx()


@contextlib.contextmanager
def domain(ctx: Optional[DomainCtx]):
    """Install a :class:`DomainCtx` for the enclosed trace."""
    prev = _ctx()
    _tls.domain = ctx
    try:
        yield
    finally:
        _tls.domain = prev


def domain_of(cfg) -> "contextlib.AbstractContextManager":
    """Context for a (possibly padded) global-array trace of ``cfg``."""
    im_act = getattr(cfg, "im_act", None) or cfg.im
    jm_act = getattr(cfg, "jm_act", None) or cfg.jm
    if im_act == cfg.im and jm_act == cfg.jm:
        return contextlib.nullcontext()
    return domain(DomainCtx(im=im_act, jm=jm_act))


class _RegionBuilder:
    """``s_[KM1, 1:-1, :]`` -> tuple of region entries (always a tuple,
    unlike numpy.s_, so ``put(base, expr, *s_[...])`` works for any arity)."""

    def __getitem__(self, item):
        return item if isinstance(item, tuple) else (item,)


s_ = _RegionBuilder()

# Common Fortran loop-bound slices (1-based bound -> 0-based slice).
# e.g. `do i=2,imm1` covers 0-based 1..im-2 -> slice(1, -1).
S_2_M1 = slice(1, -1)    # 2..(n-1)
S_2_N = slice(1, None)   # 2..n
S_1_M1 = slice(0, -1)    # 1..(n-1)
S_1_N = slice(None)      # 1..n
S_3_M1 = slice(2, -1)    # 3..(n-1)
S_1_M2 = slice(0, -2)    # 1..(n-2)


def _shift1(a: jnp.ndarray, d: int, axis: int) -> jnp.ndarray:
    """Zero-padded shift along one axis: out[i] = a[i+d] (0 outside).

    Implemented as slice + concatenate-with-zeros (not jnp.pad)."""
    if d == 0:
        return a
    ax = axis % a.ndim
    idx = lambda s: tuple(s if i == ax else slice(None)
                          for i in range(a.ndim))
    zshape = list(a.shape)
    zshape[ax] = abs(d)
    zeros = jnp.zeros(zshape, a.dtype)
    if d > 0:
        return jnp.concatenate([a[idx(slice(d, None))], zeros], axis=ax)
    else:
        return jnp.concatenate([zeros, a[idx(slice(0, d))]], axis=ax)


def _halo_shift(a: jnp.ndarray, d: int, axis: int, axis_name: str,
                nsh: int) -> jnp.ndarray:
    """Local-mode shifted read: local shift + ``lax.ppermute`` halo fill.

    The vacated strip is filled with the neighbor block's edge strip; blocks
    at the mesh boundary receive zeros (ppermute non-receivers), matching
    the global zero-fill semantics of :func:`sft`.  This is the explicit
    exchange2d/3d_mpi analogue (parallel_mpi.f:154-351): one collective
    permute of a width-|d| strip per shifted read.
    """
    ax = axis % a.ndim
    n = a.shape[ax]
    w = abs(d)
    assert w <= n, f"halo width {w} exceeds local block extent {n}"
    idx = lambda s: tuple(s if i == ax else slice(None)
                          for i in range(a.ndim))
    if d > 0:
        # read i+d: neighbor at mesh position p+1 provides its first rows
        strip = a[idx(slice(0, w))]
        perm = [(p + 1, p) for p in range(nsh - 1)]
        recv = lax.ppermute(strip, axis_name, perm)
        if d == n:
            return recv
        return jnp.concatenate([a[idx(slice(d, None))], recv], axis=ax)
    else:
        strip = a[idx(slice(n - w, None))]
        perm = [(p, p + 1) for p in range(nsh - 1)]
        recv = lax.ppermute(strip, axis_name, perm)
        if w == n:
            return recv
        return jnp.concatenate([recv, a[idx(slice(0, d))]], axis=ax)


def sft(a: jnp.ndarray, di: int = 0, dj: int = 0) -> jnp.ndarray:
    """Horizontal shifted read: ``out[..., i, j] = a[..., i+di, j+dj]``.

    Out-of-range reads yield 0, matching the reference's pattern of
    zero-initialized scratch arrays combined with partial loop ranges.
    The i axis is ``-2``, the j axis is ``-1``.  In shard_map local mode
    the shift crosses block boundaries via an explicit ppermute halo
    exchange (see :class:`DomainCtx`).
    """
    ctx = _ctx()
    out = a
    if di:
        if ctx is not None and ctx.local and ctx.px > 1:
            out = _halo_shift(out, di, -2, ctx.axis_x, ctx.px)
        else:
            out = _shift1(out, di, -2)
    if dj:
        if ctx is not None and ctx.local and ctx.py > 1:
            out = _halo_shift(out, dj, -1, ctx.axis_y, ctx.py)
        else:
            out = _shift1(out, dj, -1)
    return out


def sfk(a: jnp.ndarray, dk: int) -> jnp.ndarray:
    """Vertical shifted read along leading k axis: out[k] = a[k+dk]."""
    return _shift1(a, dk, 0)


def _axis_mask(n: int, r: Union[slice, int]) -> Tuple[int, int]:
    """Resolve a region entry to a half-open [lo, hi) on an axis of size n."""
    if isinstance(r, int):
        lo = r % n
        return lo, lo + 1
    lo, hi, step = r.indices(n)
    assert step == 1, "strided regions unsupported"
    return lo, hi


@contextlib.contextmanager
def mask_caching():
    """Memoize :func:`region_mask` by (shape, region) for the enclosed
    trace.

    The masks are pure functions of shapes, static region bounds, and the
    ambient ctx offsets, so inside a kernel they are LOOP-INVARIANT — but
    a mask built during ``lax.fori_loop`` body tracing is recomputed
    every iteration.  The rolled external kernels PEEL their first
    substep under this context so every mask becomes a pre-loop value
    the body closure-captures; unrolled loops and single-trace phase
    bodies simply deduplicate.  Scope it tightly: cached values may be
    tracers of the enclosing trace and must not leak past it.  The
    caller must keep the DomainCtx constant inside the context (the
    cache does not key on it)."""
    prev = getattr(_tls, "mask_cache", None)
    _tls.mask_cache = {}
    try:
        yield
    finally:
        _tls.mask_cache = prev


@contextlib.contextmanager
def mask_cache_pause():
    """Freeze an active mask cache (read-only) for the enclosed region.

    Required around ``lax.cond``/``lax.switch`` BRANCHES inside a cached
    trace: a mask created while tracing one branch is a value of that
    branch's (closed) jaxpr, and serving it from the cache to a later
    sibling trace leaks it across scopes.  Masks cached OUTSIDE the
    branches are ordinary closed-over values and keep being served;
    branch-local misses compute fresh and are NOT stored."""
    prev = getattr(_tls, "mask_cache_frozen", False)
    _tls.mask_cache_frozen = True
    try:
        yield
    finally:
        _tls.mask_cache_frozen = prev


def _region_key(shape, region):
    return (shape, tuple(
        r if isinstance(r, int) else (r.start, r.stop, r.step)
        for r in region))


def region_mask(shape: Tuple[int, ...], region) -> jnp.ndarray:
    """Boolean mask (broadcastable to ``shape``) that is True on ``region``.

    ``region`` entries (int or slice) apply to the LEADING len(region) axes
    of ``shape`` — exactly like ``a[region]`` numpy indexing, so
    ``put(a, e, *s_[R])`` matches ``a.at[R].set(e[R])``.  Built from
    broadcasted iota comparisons so it partitions under SPMD without
    scatter.

    Under a :class:`DomainCtx`, bounds on the trailing (i, j) axes resolve
    against the ACTIVE extents (pad cells never selected) and, in local
    mode, compare against global indices (local iota + block offset).
    """
    cache = getattr(_tls, "mask_cache", None)
    if cache is not None:
        key = _region_key(shape, region)
        hit = cache.get(key)
        if hit is not None:
            return hit
        mask = _region_mask(shape, region)
        if not getattr(_tls, "mask_cache_frozen", False):
            cache[key] = mask
        return mask
    return _region_mask(shape, region)


def _region_mask(shape: Tuple[int, ...], region) -> jnp.ndarray:
    ctx = _ctx()
    nd = len(shape)
    mask = None
    for k, r in enumerate(region):
        ax = k
        n = shape[ax]
        off = 0
        if ctx is not None and ax >= nd - 2:
            if ax == nd - 2:
                n_act, off, nsh = ctx.im, ctx.off_i, ctx.px
            else:
                n_act, off, nsh = ctx.jm, ctx.off_j, ctx.py
            lo, hi = _axis_mask(n_act, r)
            # all cells selected only if the region covers the whole active
            # extent and the axis carries no padding (local: px*n == im);
            # windowed blocks never skip (the mask restricts to the domain)
            if (not ctx.windowed and lo == 0 and hi == n_act
                    and n * (nsh if ctx.local else 1) == n_act):
                continue
        else:
            lo, hi = _axis_mask(n, r)
            if lo == 0 and hi == n:
                continue
        ii = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        if not isinstance(off, int) or off != 0:
            ii = ii + off
        m = (ii >= lo) & (ii < hi)
        mask = m if mask is None else (mask & m)
    if mask is None:
        return jnp.ones(shape, bool)
    return mask


def put(base: jnp.ndarray, expr: jnp.ndarray, *region) -> jnp.ndarray:
    """Commit ``expr`` onto ``base`` over ``region`` (ints / slices applied
    to the leading ``len(region)`` axes, numpy-style); elsewhere keep
    ``base``."""
    return jnp.where(region_mask(base.shape, region), expr, base)


def set_i(base: jnp.ndarray, i: int, val,
          j=slice(None), k=slice(None)) -> jnp.ndarray:
    """Set row ``i`` (axis -2) to ``val`` (full-width along j, broadcastable
    over leading axes) — the masked-write form of
    ``base.at[..., i, j].set``.  ``j``/``k`` optionally restrict the
    transverse range (k applies to 3-D bases only).

    ``val`` may be a FULL-SHAPE expression (the row committed is row ``i``
    of it).  Outside shard_map local mode the expression is sliced to that
    one row first, so XLA dead-code-eliminates the rest of the full-field
    computation and the edge write costs O(edge), not O(volume)."""
    ctx = _ctx()
    region = (i, j) if base.ndim == 2 else (k, i, j)
    val = jnp.asarray(val, base.dtype)
    if val.ndim == base.ndim:
        if not (ctx is not None and ctx.block):
            n = ctx.im if ctx is not None else base.shape[-2]
            # broadcast-shaped expressions (size-1 i axis) read their row
            val = val[..., (i % n) if val.shape[-2] != 1 else 0, :]
    return put(base, _expand(base, val, -2, i), *region)


def set_j(base: jnp.ndarray, j: int, val,
          i=slice(None), k=slice(None)) -> jnp.ndarray:
    """Set column ``j`` (axis -1) to ``val`` (see :func:`set_i` on
    full-shape expressions)."""
    ctx = _ctx()
    region = (i, j) if base.ndim == 2 else (k, i, j)
    val = jnp.asarray(val, base.dtype)
    j_whole = (ctx is None
               or (not ctx.local
                   and (not ctx.windowed
                        or (isinstance(ctx.off_j, int) and ctx.off_j == 0
                            and base.shape[-1] >= ctx.jm))))
    if val.ndim == base.ndim and j_whole:
        # the j axis is not blocked here (2-D-windowed traces carry a
        # traced off_j and are excluded), so the global column slicing
        # applies — O(edge) column writes
        n = ctx.jm if ctx is not None else base.shape[-1]
        val = val[..., :, (j % n) if val.shape[-1] != 1 else 0]
    return put(base, _expand(base, val, -1, j), *region)


def set_k(base: jnp.ndarray, k: int, val) -> jnp.ndarray:
    """Set level ``k`` (axis 0 of a (kb, ...) array) to ``val``."""
    nd = base.ndim
    region = (k,) + (slice(None),) * (nd - 1)
    return put(base, _expand(base, val, 0, k), *region)


def _expand(base: jnp.ndarray, val, axis: int, idx: int) -> jnp.ndarray:
    """Broadcast a slice-shaped ``val`` back to ``base``'s shape along
    ``axis`` (value is only read on the masked row/col, placement is
    irrelevant elsewhere)."""
    val = jnp.asarray(val, base.dtype)
    if val.ndim == base.ndim:
        return val
    if val.ndim == 0:
        return jnp.broadcast_to(val, base.shape)
    return jnp.broadcast_to(jnp.expand_dims(val, axis), base.shape)


def row(a: jnp.ndarray, i: int) -> jnp.ndarray:
    """``a[..., i, :]`` with a python-int index resolved statically against
    the ACTIVE i extent.

    jnp lowers negative-literal indexing through ``dynamic_slice`` (it emits
    a sign-normalization select); ``i % n`` resolves the index at trace
    time instead.  Not available in shard_map local mode (a global-row
    read is a collective) — express edge logic through :func:`sft` +
    :func:`set_i` instead."""
    ctx = _ctx()
    if ctx is not None and ctx.block:
        raise RuntimeError("row() reads a global row; not supported on "
                           "local/windowed blocks — use sft/set_i forms")
    n = ctx.im if ctx is not None else a.shape[-2]
    return a[..., i % n, :]


def col(a: jnp.ndarray, j: int) -> jnp.ndarray:
    """``a[..., :, j]`` with a static python-int index (see :func:`row`)."""
    ctx = _ctx()
    if ctx is not None and ctx.block:
        raise RuntimeError("col() reads a global column; not supported "
                           "on local/windowed blocks — use sft/set_j forms")
    n = ctx.jm if ctx is not None else a.shape[-1]
    return a[..., :, j % n]


def zeros_like(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.zeros_like(a)

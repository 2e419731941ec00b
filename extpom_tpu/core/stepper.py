"""Mode-split leapfrog time stepping.

One call to :func:`step` advances the model by one internal (3-D) time step
``dti``, mirroring ``advance`` (advance.f:6-59):

    lateral_viscosity -> mode_interaction -> isplit x mode_external
    -> mode_internal

The whole thing is a pure function ``(grid, cfg static, state, forcing) ->
state`` designed to be wrapped in ``jax.jit`` with ``donate_argnums`` for
the state (so leapfrog level rotation is in place in device memory).  The
external substeps run under ``lax.fori_loop``; the iext-dependent
tail-averaging of ``etf`` (advance.f:295-318) is branchless.

Forcing reads stay on the host (see ``extpom_tpu.forcing``); the traced step
never touches files.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.core.state import State, Forcing
from extpom_tpu.ops.stencil import sft, sfk, put
from extpom_tpu.ops import advection2d, momentum, tracers, pressure, \
    vertical, continuity, density
from extpom_tpu.bc import bcond as bcf
from extpom_tpu.bc import orlanski as bco


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def mode_interaction(grid: Grid, cfg: Config, st: State,
                     aam, advx, advy, drhox, drhoy):
    """Vertical integrals feeding the external mode (advance.f:144-202).

    Returns (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
    egf, utf, vtf)."""
    d = grid.h + st.el
    dz3 = grid.dz3[:cfg.kbm1]

    if cfg.mode != 2:
        adx2d = jnp.sum(advx[:cfg.kbm1] * dz3, axis=0)
        ady2d = jnp.sum(advy[:cfg.kbm1] * dz3, axis=0)
        drx2d = jnp.sum(drhox[:cfg.kbm1] * dz3, axis=0)
        dry2d = jnp.sum(drhoy[:cfg.kbm1] * dz3, axis=0)
        aam2d = jnp.sum(aam[:cfg.kbm1] * dz3, axis=0)
        advua, advva, wubot, wvbot = advection2d.advave(
            grid, cfg, d, st.ua, st.va, st.uab, st.vab, aam2d,
            st.wubot, st.wvbot)
        adx2d = adx2d - advua
        ady2d = ady2d - advva
    else:
        adx2d, ady2d = st.adx2d, st.ady2d
        drx2d, dry2d = st.drx2d, st.dry2d
        aam2d = st.aam2d
        advua, advva, wubot, wvbot = st.advua, st.advva, st.wubot, st.wvbot

    egf = st.el * cfg.ispi
    z2 = jnp.zeros_like(d)
    utf = put(z2, st.ua * (d + sft(d, -1, 0)) * cfg.isp2i,
              slice(1, None), slice(None))
    vtf = put(z2, st.va * (d + sft(d, 0, -1)) * cfg.isp2i,
              slice(None), slice(1, None))

    return (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
            egf, utf, vtf)


def ext_precompute(grid):
    """Loop-invariant derived metrics of the external mode, hoisted out of
    the isplit substep loop: these static shift/sum/reciprocal
    subexpressions would otherwise be recomputed every substep — ~18
    shifted adds and ~6 divides per point per substep in
    advance.f:205-353 + solver.f:16-121 terms.

    Call ONCE per trace under the ambient DomainCtx (under shard_map local
    mode the sft halo permutes then run once instead of per substep).
    Consumes one extra halo cell relative to the substep chain — covered
    by ext_halo_sub's margin (radius 2 + 1 <= 3/substep).

    Reciprocals (rart, rdx, rdy, rdx4, rdy4) replace divisions by static
    metrics with multiplies; results differ from the reference's division
    only at the ULP level (oracle tolerances 1e-8..1e-10 at f64)."""
    from types import SimpleNamespace
    dx, dy, h, cor, art = grid.dx, grid.dy, grid.h, grid.cor, grid.art
    one = jnp.ones((), dx.dtype)
    dx4 = dx + sft(dx, -1, 0) + sft(dx, 0, -1) + sft(dx, -1, -1)
    dy4 = dy + sft(dy, -1, 0) + sft(dy, 0, -1) + sft(dy, -1, -1)
    return SimpleNamespace(
        dyu=dy + sft(dy, -1, 0),       # u-face dy pair (advance.f:212,254)
        dxv=dx + sft(dx, 0, -1),       # v-face dx pair (advance.f:216,272)
        hu=h + sft(h, -1, 0),          # u-face depth pair (advance.f:261-266)
        hv=h + sft(h, 0, -1),
        corw=sft(cor, -1, 0),          # Coriolis neighbors (advance.f:243,276)
        cors=sft(cor, 0, -1),
        rart=one / art,
        rdx=one / dx,
        rdy=one / dy,
        dx4=dx4,                       # corner sums (solver.f:20-23)
        dy4=dy4,
        rdx4=one / jnp.where(dx4 == 0, one, dx4),
        rdy4=one / jnp.where(dy4 == 0, one, dy4),
    )


class ExtCarry(NamedTuple):
    el: jnp.ndarray
    elb: jnp.ndarray
    ua: jnp.ndarray
    uab: jnp.ndarray
    va: jnp.ndarray
    vab: jnp.ndarray
    etf: jnp.ndarray
    egf: jnp.ndarray
    utf: jnp.ndarray
    vtf: jnp.ndarray
    advua: jnp.ndarray
    advva: jnp.ndarray
    wubot: jnp.ndarray
    wvbot: jnp.ndarray


def mode_external_substep(grid: Grid, cfg: Config, c: ExtCarry, iext,
                          fc: Forcing, aux, em=None) -> ExtCarry:
    """One external (2-D) leapfrog substep (advance.f:205-353).

    ``iext`` is the 1-based substep counter (traced); ``aux`` holds the
    step-constant 2-D forcing terms (adx2d, ady2d, drx2d, dry2d, aam2d,
    wusurf, wvsurf, vfluxf, e_atmos, ramp); ``em`` the loop-invariant
    derived metrics (:func:`ext_precompute`, computed here when the
    caller has no loop to hoist them out of)."""
    (adx2d, ady2d, drx2d, dry2d, aam2d) = aux
    if em is None:
        em = ext_precompute(grid)
    h, aru, arv, cor = grid.h, grid.aru, grid.arv, grid.cor
    d = h + c.el
    z2 = jnp.zeros_like(d)

    # free surface (advance.f:211-229)
    fluxua = put(z2, 0.25 * (d + sft(d, -1, 0)) * em.dyu * c.ua,
                 slice(1, None), slice(1, None))
    fluxva = put(z2, 0.25 * (d + sft(d, 0, -1)) * em.dxv * c.va,
                 slice(1, None), slice(1, None))
    elf = put(z2, c.elb + cfg.dte2 * (
        -(sft(fluxua, 1, 0) - fluxua + sft(fluxva, 0, 1) - fluxva) * em.rart
        - fc.vflux),
        slice(1, -1), slice(1, -1))
    if cfg.bc_scheme == "orlanski":
        elf = bco.orl_el(grid, cfg, elf)
    else:
        elf = bcf.bc_el(grid, cfg, elf, fc)

    # external advection terms every ispadv substeps (advance.f:235)
    def do_advave(c):
        advua, advva, wubot, wvbot = advection2d.advave(
            grid, cfg, d, c.ua, c.va, c.uab, c.vab, aam2d,
            c.wubot, c.wvbot, em=em)
        return advua, advva, wubot, wvbot

    if cfg.ispadv == 1:
        advua, advva, wubot, wvbot = do_advave(c)
    else:
        from extpom_tpu.ops.stencil import mask_cache_pause
        with mask_cache_pause():
            # masks built while tracing a cond BRANCH must not enter the
            # loop-invariant cache (they belong to the branch jaxpr)
            advua, advva, wubot, wvbot = lax.cond(
                iext % cfg.ispadv == 0,
                lambda c: do_advave(c),
                lambda c: (c.advua, c.advva, c.wubot, c.wvbot),
                c)

    # depth-mean momentum (advance.f:237-288)
    alpha = cfg.alpha
    uaf = put(z2,
              adx2d + advua
              - aru * 0.25 * (cor * d * (sft(c.va, 0, 1) + c.va)
                              + em.corw * sft(d, -1, 0)
                              * (sft(c.va, -1, 1) + sft(c.va, -1, 0)))
              + 0.25 * cfg.grav * em.dyu * (d + sft(d, -1, 0))
              * ((1.0 - 2.0 * alpha) * (c.el - sft(c.el, -1, 0))
                 + alpha * (c.elb - sft(c.elb, -1, 0)
                            + elf - sft(elf, -1, 0))
                 + fc.e_atmos - sft(fc.e_atmos, -1, 0))
              + drx2d + aru * (fc.wusurf - wubot),
              slice(1, None), slice(1, -1))
    uaf = put(z2,
              ((em.hu + c.elb + sft(c.elb, -1, 0)) * aru * c.uab
               - 4.0 * cfg.dte * uaf)
              / ((em.hu + elf + sft(elf, -1, 0)) * aru),
              slice(1, None), slice(1, -1))

    vaf = put(z2,
              ady2d + advva
              + arv * 0.25 * (cor * d * (sft(c.ua, 1, 0) + c.ua)
                              + em.cors * sft(d, 0, -1)
                              * (sft(c.ua, 1, -1) + sft(c.ua, 0, -1)))
              + 0.25 * cfg.grav * em.dxv * (d + sft(d, 0, -1))
              * ((1.0 - 2.0 * alpha) * (c.el - sft(c.el, 0, -1))
                 + alpha * (c.elb - sft(c.elb, 0, -1)
                            + elf - sft(elf, 0, -1))
                 + fc.e_atmos - sft(fc.e_atmos, 0, -1))
              + dry2d + arv * (fc.wvsurf - wvbot),
              slice(1, -1), slice(1, None))
    vaf = put(z2,
              ((em.hv + c.elb + sft(c.elb, 0, -1)) * arv * c.vab
               - 4.0 * cfg.dte * vaf)
              / ((em.hv + elf + sft(elf, 0, -1)) * arv),
              slice(1, -1), slice(1, None))

    if cfg.bc_scheme == "orlanski":
        uaf, vaf = bco.orl_vel2d(grid, cfg, uaf, vaf, c.ua, c.uab,
                                 c.va, c.vab)
    else:
        uaf, vaf = bcf.bc_vel2d(grid, cfg, uaf, vaf, c.el, d, fc, fc.ramp)

    # etf tail averaging over the last three substeps (advance.f:295-318)
    isplit = cfg.isplit
    etf = c.etf
    etf = jnp.where(iext == isplit - 2, 0.25 * cfg.smoth * elf, etf)
    etf = jnp.where(iext == isplit - 1,
                    c.etf + 0.5 * (1.0 - 0.5 * cfg.smoth) * elf, etf)
    etf = jnp.where(iext == isplit,
                    (c.etf + 0.5 * elf) * grid.fsm, etf)

    # Asselin filter + time level rotation (advance.f:321-330)
    ua = c.ua + 0.5 * cfg.smoth * (c.uab - 2.0 * c.ua + uaf)
    va = c.va + 0.5 * cfg.smoth * (c.vab - 2.0 * c.va + vaf)
    el = c.el + 0.5 * cfg.smoth * (c.elb - 2.0 * c.el + elf)
    elb = el
    el = elf
    d = h + el
    uab = ua
    ua = uaf
    vab = va
    va = vaf

    # dti-average accumulators, skipped on the final substep
    # (advance.f:332-350)
    not_last = (iext != isplit).astype(el.dtype)
    egf = c.egf + not_last * el * cfg.ispi
    utf = put(c.utf, c.utf + not_last * ua * (d + sft(d, -1, 0)) * cfg.isp2i,
              slice(1, None), slice(None))
    vtf = put(c.vtf, c.vtf + not_last * va * (d + sft(d, 0, -1)) * cfg.isp2i,
              slice(None), slice(1, None))

    return ExtCarry(el=el, elb=elb, ua=ua, uab=uab, va=va, vab=vab,
                    etf=etf, egf=egf, utf=utf, vtf=vtf,
                    advua=advua, advva=advva, wubot=wubot, wvbot=wvbot)


def phase_uvw(grid, cfg: Config, u, v, w, dt, utb, vtb, utf, vtf,
              etb, etf, vfluxb, vflux):
    """Depth-mean adjustment of u,v + vertical velocity
    (advance.f:364-400).  Returns (u, v, w)."""
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    dz3 = grid.dz3[:kbm1]
    tps = jnp.sum(u[:kbm1] * dz3, axis=0)
    u = put(u, (u - tps) + (utb + utf) / (dt + sft(dt, -1, 0)),
            KM1, slice(1, None), slice(None))
    tps = jnp.sum(v[:kbm1] * dz3, axis=0)
    v = put(v, (v - tps) + (vtb + vtf) / (dt + sft(dt, 0, -1)),
            KM1, slice(None), slice(1, None))
    w = continuity.vertvl(grid, cfg, w, u, v, dt, etf, etb, vfluxb, vflux)
    w = bco.orl_w(grid, cfg, w)   # idx 5 is a pure mask in both schemes
    return u, v, w


def phase_tke(grid, cfg: Config, q2, q2b, q2l, q2lb, u, v, w, aam,
              t, s, rho, km, kh, kq, l, dt, etb, etf,
              wubot, wvbot, fc):
    """TKE pair advection + MY-2.5 closure + BC + Asselin/rotate
    (advance.f:406-421).  Returns the new
    (q2, q2b, q2l, q2lb, km, kh, kq, l)."""
    q2f = tracers.advq(grid, cfg, q2b, q2, u, v, w, aam, dt, etb, etf)
    q2lf = tracers.advq(grid, cfg, q2lb, q2l, u, v, w, aam, dt, etb, etf)
    (q2f, q2lf, km, kh, kq, l, q2b, q2lb) = vertical.profq(
        grid, cfg, q2f, q2lf, q2, q2b, q2lb, u, v, t, s, rho,
        km, kh, kq, l, etf, fc.wusurf, fc.wvsurf, wubot, wvbot)
    if cfg.bc_scheme == "orlanski":
        q2f, q2lf = bco.orl_turb(grid, cfg, q2f, q2lf)
    else:
        q2f, q2lf = bcf.bc_turb(grid, cfg, q2f, q2lf, q2, q2l, u, v)

    q2 = q2 + 0.5 * cfg.smoth * (q2f + q2b - 2.0 * q2)
    q2l = q2l + 0.5 * cfg.smoth * (q2lf + q2lb - 2.0 * q2l)
    return q2f, q2, q2lf, q2l, km, kh, kq, l


def phase_tracer(grid, cfg: Config, t, tb, s, sb, tclim, sclim,
                 u, ub, v, w, aam, kh, dt, etb, etf, fc):
    """Tracer advection + implicit diffusion + BC + Asselin/rotate +
    restoring + EOS (advance.f:424-456).  Returns the new
    (t, tb, s, sb, rho)."""
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    adv = tracers.advt1 if cfg.nadv == 1 else tracers.advt2
    tf = adv(grid, cfg, tb, t, tclim, u, v, w, aam, dt, etb, etf)
    sf = adv(grid, cfg, sb, s, sclim, u, v, w, aam, dt, etb, etf)
    tf = vertical.proft(grid, cfg, tf, fc.wtsurf, fc.tsurf,
                        cfg.nbct, kh, etf, fc.swrad)
    sf = vertical.proft(grid, cfg, sf, fc.wssurf, fc.ssurf,
                        cfg.nbcs, kh, etf, fc.swrad)
    if cfg.bc_scheme == "orlanski":
        tf, sf = bco.orl_ts(grid, cfg, tf, sf, t, tb, s, sb, ub, fc)
    else:
        tf, sf = bcf.bc_ts(grid, cfg, tf, sf, t, s, u, v, w, dt, fc)

    t = t + 0.5 * cfg.smoth * (tf + tb - 2.0 * t)
    s = s + 0.5 * cfg.smoth * (sf + sb - 2.0 * s)
    tb = t
    t = tf
    sb = s
    s = sf

    if cfg.do_restore:
        # interior restoring toward climatology (bounds_forcing.f:1097-1118)
        fac = 2.0 * cfg.dti / 86400.0 * fc.taurstr
        A = (slice(None), slice(None))
        t = put(t, (t + fac * (fc.trstr - t)) * grid.fsm, KM1, *A)
        tb = put(tb, (tb + fac * (fc.trstr - tb)) * grid.fsm, KM1, *A)
        s = put(s, (s + fac * (fc.srstr - s)) * grid.fsm, KM1, *A)
        sb = put(sb, (sb + fac * (fc.srstr - sb)) * grid.fsm, KM1, *A)

    rho = density.dens(grid, cfg, s, t)
    return t, tb, s, sb, rho


def phase_mom(grid, cfg: Config, u, ub, v, vb, w, advx, advy,
              drhox, drhoy, km, dt, egf, egb, etb, etf, d, fc):
    """Momentum advection + implicit vertical diffusion/bottom friction +
    BC + Asselin/rotate (advance.f:459-521).  ``d = h + el`` feeds the
    file-BC depth blend.  Returns the new (u, ub, v, vb, wubot, wvbot)."""
    kbm1 = cfg.kbm1
    dz3 = grid.dz3[:kbm1]
    uf = momentum.advu(grid, cfg, u, ub, v, w, advx, drhox, dt,
                       egf, egb, fc.e_atmos, etb, etf)
    vf = momentum.advv(grid, cfg, v, vb, u, w, advy, drhoy, dt,
                       egf, egb, fc.e_atmos, etb, etf)
    uf, wubot = vertical.profu(grid, cfg, uf, ub, vb, km, etf, fc.wusurf)
    vf, wvbot = vertical.profv(grid, cfg, vf, ub, vb, km, etf, fc.wvsurf)
    if cfg.bc_scheme == "file":
        uf, vf = bcf.bc_vel3d(grid, cfg, uf, vf, u, v, d, fc)
    else:
        uf, vf = bco.orl_vel3d(grid, cfg, uf, vf, u, ub, v, vb)

    # Asselin filter with depth-mean correction (advance.f:469-509)
    tps = jnp.sum((uf + ub - 2.0 * u)[:kbm1] * dz3, axis=0)
    u = u + 0.5 * cfg.smoth * (uf + ub - 2.0 * u - tps)
    tps = jnp.sum((vf + vb - 2.0 * v)[:kbm1] * dz3, axis=0)
    v = v + 0.5 * cfg.smoth * (vf + vb - 2.0 * v - tps)
    return uf, u, vf, v, wubot, wvbot


def mode_internal(grid: Grid, cfg: Config, st: State, fc: Forcing,
                  c: ExtCarry, aam, advx, advy, drhox, drhoy,
                  rmean, tclim, sclim, first: bool) -> State:
    """Internal (3-D) mode update (advance.f:356-537).

    ``first=True`` reproduces the reference's cold-start behavior where the
    3-D update block is skipped on the very first step (advance.f:362).
    """
    h = grid.h
    dt = h + st.et     # pre-update dt (time n)
    etf = c.etf

    u, ub, v, vb, w = st.u, st.ub, st.v, st.vb, st.w
    t, tb, s, sb, rho = st.t, st.tb, st.s, st.sb, st.rho
    q2, q2b, q2l, q2lb = st.q2, st.q2b, st.q2l, st.q2lb
    km, kh, kq, l = st.km, st.kh, st.kq, st.l
    wubot, wvbot = c.wubot, c.wvbot

    if (not first) and cfg.mode != 2:
        with jax.named_scope("phase_uvw"):
            u, v, w = phase_uvw(grid, cfg, u, v, w, dt, st.utb, st.vtb,
                                c.utf, c.vtf, st.etb, etf, st.vfluxb,
                                fc.vflux)
        with jax.named_scope("phase_tke"):
            (q2, q2b, q2l, q2lb, km, kh, kq, l) = phase_tke(
                grid, cfg, q2, q2b, q2l, q2lb, u, v, w, aam, t, s, rho,
                km, kh, kq, l, dt, st.etb, etf, wubot, wvbot, fc)
        if cfg.mode != 4:
            with jax.named_scope("phase_tracer"):
                t, tb, s, sb, rho = phase_tracer(
                    grid, cfg, t, tb, s, sb, tclim, sclim, u, ub, v, w,
                    aam, kh, dt, st.etb, etf, fc)
        with jax.named_scope("phase_mom"):
            u, ub, v, vb, wubot, wvbot = phase_mom(
                grid, cfg, u, ub, v, vb, w, advx, advy, drhox, drhoy,
                km, dt, c.egf, st.egb, st.etb, etf, h + c.el, fc)

    # final time-level copies (advance.f:525-531)
    return st.replace(
        u=u, ub=ub, v=v, vb=vb, w=w, t=t, tb=tb, s=s, sb=sb, rho=rho,
        q2=q2, q2b=q2b, q2l=q2l, q2lb=q2lb, km=km, kh=kh, kq=kq, l=l,
        aam=aam,
        el=c.el, elb=c.elb, ua=c.ua, uab=c.uab, va=c.va, vab=c.vab,
        egb=c.egf,
        etb=st.et, et=etf, etf=etf,
        utb=c.utf, vtb=c.vtf,
        vfluxb=fc.vflux, vfluxf=fc.vflux,
        advua=c.advua, advva=c.advva, wubot=wubot, wvbot=wvbot,
    )


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------

def step(grid: Grid, cfg: Config, st: State, fc: Forcing,
         rmean: jnp.ndarray, tclim: jnp.ndarray, sclim: jnp.ndarray,
         first: bool = False) -> State:
    """Advance one internal time step (advance.f:6-59, minus host-side I/O).

    ``rmean``/``tclim``/``sclim`` are the climatology fields (static over a
    run, but passed as arrays so one compilation serves any case).
    """
    from extpom_tpu.ops import stencil
    ctx = stencil.domain_ctx()
    if ctx is not None and ctx.block:
        # already tracing under a shard_map local (or windowed) ctx —
        # e.g. run_steps inside mesh.shardmap.make_shardmap_run; the
        # padded-extent ctx that domain_of would install must NOT
        # replace it (a global-shift trace on local blocks would be
        # silently wrong on ragged grids)
        return _step(grid, cfg, st, fc, rmean, tclim, sclim, first)
    with stencil.domain_of(cfg):
        return _step(grid, cfg, st, fc, rmean, tclim, sclim, first)


def phase_lat(grid, cfg: Config, u, v, ub, vb, aam0, rho, rmean,
              dt, d, ramp):
    """Lateral viscosity + 3-D advection/pressure terms
    (lateral_viscosity, advance.f:96-141) -> (aam, advx, advy, drhox,
    drhoy).  ``ramp`` may be a scalar or a (1, jm) broadcast row (the
    windowed-kernel form)."""
    advx, advy = momentum.advct(grid, cfg, u, v, ub, vb, aam0, dt)
    if cfg.npg == 1:
        drhox, drhoy = pressure.baropg(grid, cfg, rho, rmean, dt, ramp)
    else:
        drhox, drhoy = pressure.baropg_mcc(grid, cfg, rho, rmean,
                                           d, dt, ramp)
    dx, dy = grid.dx, grid.dy
    aam_new = (cfg.horcon * dx * dy
               * jnp.sqrt(((sft(u, 1, 0) - u) / dx) ** 2
                          + ((sft(v, 0, 1) - v) / dy) ** 2
                          + 0.5 * (0.25 * (sft(u, 0, 1) + sft(u, 1, 1)
                                           - sft(u, 0, -1) - sft(u, 1, -1))
                                   / dy
                                   + 0.25 * (sft(v, 1, 0) + sft(v, 1, 1)
                                             - sft(v, -1, 0)
                                             - sft(v, -1, 1))
                                   / dx) ** 2))
    aam = put(aam0, aam_new, slice(0, cfg.kbm1),
              slice(1, -1), slice(1, -1))
    return aam, advx, advy, drhox, drhoy


def lateral_terms(grid: Grid, cfg: Config, st: State, fc: Forcing,
                  rmean: jnp.ndarray):
    """Lateral viscosity + 3-D advection/pressure terms
    (lateral_viscosity, advance.f:96-141) -> (aam, advx, advy, drhox,
    drhoy); Nones for mode 2."""
    if cfg.mode == 2:
        return st.aam, None, None, None, None
    dt = grid.h + st.et
    return phase_lat(grid, cfg, st.u, st.v, st.ub, st.vb, st.aam,
                     st.rho, rmean, dt, grid.h + st.el, fc.ramp)


def _step(grid: Grid, cfg: Config, st: State, fc: Forcing,
          rmean: jnp.ndarray, tclim: jnp.ndarray, sclim: jnp.ndarray,
          first: bool = False) -> State:
    # lateral viscosity + 3-D advection/pressure terms (advance.f:21)
    with jax.named_scope("lateral_terms"):
        aam, advx, advy, drhox, drhoy = lateral_terms(grid, cfg, st, fc,
                                                      rmean)

    # vertical averages for the external mode (advance.f:24)
    with jax.named_scope("mode_interaction"):
        (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
         egf, utf, vtf) = mode_interaction(grid, cfg, st, aam, advx, advy,
                                           drhox, drhoy)

    # external mode loop (advance.f:27-29)
    carry0 = ExtCarry(el=st.el, elb=st.elb, ua=st.ua, uab=st.uab,
                      va=st.va, vab=st.vab, etf=st.etf, egf=egf,
                      utf=utf, vtf=vtf, advua=advua, advva=advva,
                      wubot=wubot, wvbot=wvbot)
    aux = (adx2d, ady2d, drx2d, dry2d, aam2d)

    from extpom_tpu.ops import stencil
    from extpom_tpu.mesh import extchunk
    with jax.named_scope("external_mode"):
        if extchunk.use_chunked_local(cfg, stencil.domain_ctx(),
                                      carry0.el.shape):
            # shard_map local mode: one halo-ring exchange per C substeps
            carry = extchunk.run_external_loop_chunked(
                grid, cfg, carry0, fc, aux, stencil.domain_ctx())
        else:
            em = ext_precompute(grid)

            def body(i, c):
                return mode_external_substep(grid, cfg, c, i, fc, aux,
                                             em=em)

            carry = lax.fori_loop(1, cfg.isplit + 1, body, carry0,
                                  unroll=min(cfg.ext_unroll, cfg.isplit))

    # internal mode (advance.f:32)
    st = mode_internal(grid, cfg, st, fc, carry, aam, advx, advy,
                       drhox, drhoy, rmean, tclim, sclim, first)
    return st.replace(adx2d=adx2d, ady2d=ady2d, drx2d=drx2d, dry2d=dry2d,
                      aam2d=aam2d)


def run_steps(grid: Grid, cfg: Config, st: State, fc: Forcing,
              rmean: jnp.ndarray, tclim: jnp.ndarray, sclim: jnp.ndarray,
              iint0, n_steps: int, period_days: float,
              time0_days: float = 0.0, first: bool = False,
              plan=None) -> State:
    """Advance ``n_steps`` internal steps under one ``lax.scan``.

    The production execution path: amortizes per-step dispatch (one device
    launch for the whole segment — the reference's `do iint=1,iend` loop,
    pom.f:16-22).  The inertial ramp is recomputed per step (get_time,
    advance.f:62-75).  With a staged :class:`extpom_tpu.forcing.device.
    DevicePlan`, time-varying forcing (wind/heat/lateral-BC series) is
    interpolated on device INSIDE the scan; otherwise ``fc`` is held
    constant across the segment.
    """
    dt_ = cfg.jnp_dtype

    def one(st, i, is_first):
        t_days = cfg.dti * i.astype(dt_) / 86400.0 + time0_days
        if cfg.lramp:
            ramp = jnp.minimum(t_days / period_days, 1.0).astype(dt_)
        else:
            ramp = jnp.asarray(1.0, dt_)
        if plan is not None:
            from extpom_tpu.forcing import device as fdev
            with jax.named_scope("forcing_interp"):
                fc_i = fdev.forcing_at(plan, fc, cfg, grid.dz, t_days)
        else:
            fc_i = fc
        return step(grid, cfg, st, fc_i.replace(ramp=ramp),
                    rmean, tclim, sclim, first=is_first)

    if first:
        st = one(st, jnp.asarray(iint0) + 1, True)
        start = 1
    else:
        start = 0
    if n_steps - start <= 0:
        return st

    def body(st, i):
        return one(st, i, False), None

    st, _ = lax.scan(body, st,
                     jnp.arange(start + 1, n_steps + 1) + iint0)
    return st


def make_run_fn(cfg: Config, period_days: float,
                time0_days: float = 0.0, donate: bool = True):
    """Jitted segment runner: (grid, state, fc, rmean, tclim, sclim, iint0,
    n_steps static, first static, plan) -> state.

    ``grid`` is an argument (not a closure) so sharded — possibly
    non-addressable multi-process — grids never become jit constants."""
    kw = dict(static_argnames=("n_steps", "first"))
    if donate:
        kw["donate_argnums"] = (1,)

    @functools.partial(jax.jit, **kw)
    def _run(grid, st, fc, rmean, tclim, sclim, iint0, n_steps,
             first=False, plan=None):
        return run_steps(grid, cfg, st, fc, rmean, tclim, sclim, iint0,
                         n_steps, period_days, time0_days, first=first,
                         plan=plan)

    return _run


def make_step_fn(cfg: Config, donate: bool = True):
    """Build the jitted step function
    ``(grid, st, fc, rmean, tclim, sclim, first=...) -> st``.

    ``grid`` is an argument (not a closure) — see :func:`make_run_fn`."""
    kw = dict(static_argnames=("first",))
    if donate:
        kw["donate_argnums"] = (1,)

    @functools.partial(jax.jit, **kw)
    def _step(grid, st, fc, rmean, tclim, sclim, first=False):
        return step(grid, cfg, st, fc, rmean, tclim, sclim, first=first)

    return _step

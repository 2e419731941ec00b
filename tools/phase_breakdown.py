"""Decompose full-step time into phases on the attached GPU.

Times jitted sub-functions (external loop only / internal pieces) at a
given size.  Dispatch overhead inflates small pieces; treat as indicative.

Usage: python tools/phase_breakdown.py [--size 256] [--kb 31]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from extpom_tpu.utils.cache import enable_compile_cache

enable_compile_cache()


def timeit(name, f, *args, n=50):
    """Time f on-device: run n dependent iterations inside ONE dispatch
    (each iteration's input is perturbed by the previous output's first
    element so XLA cannot hoist the loop-invariant computation), minus the
    measured dispatch floor."""
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def loop(args):
        def body(i, carry):
            acc, args = carry
            r = f(*jax.tree_util.tree_map(
                lambda a: a + acc.astype(a.dtype) * jnp.asarray(1e-30,
                                                                a.dtype)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype,
                                                          jnp.floating)
                else a, args))
            # reduce over EVERY output leaf so nothing is dead-code
            # eliminated from the timed body
            acc = jnp.float32(0)
            for leaf in jax.tree_util.tree_leaves(r):
                if hasattr(leaf, "dtype") and jnp.issubdtype(
                        leaf.dtype, jnp.floating):
                    acc = acc + jnp.sum(leaf).astype(jnp.float32)
            return (acc, args)
        return lax.fori_loop(0, n, body, (jnp.float32(0), args))[0]

    r = loop(args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    r = loop(args)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:30s} {dt*1e3:8.3f} ms", flush=True)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--kb", type=int, default=31)
    args = ap.parse_args()

    from extpom_tpu.cases.seamount import seamount_model
    from extpom_tpu.core import stepper
    from extpom_tpu.ops import momentum, tracers, vertical, pressure, \
        continuity, density

    m = seamount_model(im=args.size, jm=args.size, kb=args.kb)
    grid, cfg, st = m.grid, m.cfg, m.state
    fc = m.forcing_at(1)
    dt2 = grid.h + st.et

    (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
     egf, utf, vtf) = jax.jit(lambda: stepper.mode_interaction(
        grid, cfg, st, st.aam, st.aam * 0, st.aam * 0, st.aam * 0,
        st.aam * 0))()
    c0 = stepper.ExtCarry(el=st.el, elb=st.elb, ua=st.ua, uab=st.uab,
                          va=st.va, vab=st.vab, etf=st.etf, egf=egf,
                          utf=utf, vtf=vtf, advua=advua, advva=advva,
                          wubot=wubot, wvbot=wvbot)
    aux = (adx2d, ady2d, drx2d, dry2d, aam2d)

    @jax.jit
    def ext_loop(c0):
        body = lambda i, c: stepper.mode_external_substep(grid, cfg, c, i,
                                                          fc, aux)
        return jax.lax.fori_loop(1, cfg.isplit + 1, body, c0)

    @jax.jit
    def full(st):
        return stepper.step(grid, cfg, st, fc, m.rmean, m.tclim, m.sclim)

    @jax.jit
    def advct_f(st):
        return momentum.advct(grid, cfg, st.u, st.v, st.ub, st.vb, st.aam,
                              dt2)

    @jax.jit
    def baropg_f(st):
        return pressure.baropg(grid, cfg, st.rho, m.rmean, dt2, fc.ramp)

    @jax.jit
    def profq_f(st):
        return vertical.profq(grid, cfg, st.q2, st.q2l, st.q2, st.q2b,
                              st.q2lb, st.u, st.v, st.t, st.s, st.rho,
                              st.km, st.kh, st.kq, st.l, st.etf,
                              fc.wusurf, fc.wvsurf, st.wubot, st.wvbot)

    @jax.jit
    def advt1_f(st):
        return tracers.advt1(grid, cfg, st.tb, st.t, m.tclim, st.u, st.v,
                             st.w, st.aam, dt2, st.etb, st.etf)

    @jax.jit
    def proft_f(st):
        return vertical.proft(grid, cfg, st.t, fc.wtsurf, fc.tsurf, 1,
                              st.kh, st.etf, fc.swrad)

    @jax.jit
    def profu_f(st):
        return vertical.profu(grid, cfg, st.u, st.ub, st.vb, st.km,
                              st.etf, fc.wusurf)

    @jax.jit
    def advu_f(st):
        return momentum.advu(grid, cfg, st.u, st.ub, st.v, st.w, st.u * 0,
                             st.u * 0, dt2, egf, st.egb, fc.e_atmos,
                             st.etb, st.etf)

    @jax.jit
    def vertvl_f(st):
        return continuity.vertvl(grid, cfg, st.w, st.u, st.v, dt2, st.etf,
                                 st.etb, st.vfluxb, fc.vflux)

    @jax.jit
    def dens_f(st):
        return density.dens(grid, cfg, st.s, st.t)

    t_full = timeit("full step", full, st)
    t_ext = timeit(f"external loop x{cfg.isplit}", ext_loop, c0)
    t = 0.0
    t += timeit("advct", advct_f, st)
    t += timeit("baropg", baropg_f, st)
    t += timeit("profq (MY-2.5)", profq_f, st)
    t += 2 * timeit("advt1 (x2 T,S)", advt1_f, st)
    t += 2 * timeit("proft (x2 T,S)", proft_f, st)
    t += 2 * timeit("profu/profv (x2)", profu_f, st)
    t += 2 * timeit("advu/advv (x2)", advu_f, st)
    t += timeit("vertvl", vertvl_f, st)
    t += timeit("dens", dens_f, st)
    print(f"{'sum of pieces + ext':30s} {(t + t_ext)*1e3:8.3f} ms "
          f"(full = {t_full*1e3:.3f} ms)")


if __name__ == "__main__":
    main()

"""Run configuration.

Replaces the reference's two-stage config system: the hard-coded physical
constants + ``&pom_nml`` namelist of ``read_input`` (initialize.f:67-244) and
the compile-time geometry of ``pom.h`` (pom.h_dist:22-28).  Everything is a
plain frozen dataclass so a :class:`Config` is hashable and can be closed
over by jitted step functions (all branches on these values are resolved at
trace time).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Config:
    """Static model configuration.

    Field semantics follow the reference namelist (pom.nml_dist:24-81) and
    the constants block of ``read_input`` (initialize.f:76-170).
    """

    # -- domain geometry (pom.h_dist:22-28; global sizes, no per-rank tiles) --
    im: int
    jm: int
    kb: int
    # Active extents when arrays are PADDED for a non-divisible mesh
    # decomposition (pad-and-mask, the analogue of the reference's shrunken
    # ragged edge tiles, parallel_mpi.f:88-105).  None means im/jm are fully
    # active (no padding).  See extpom_tpu.mesh.padding.
    im_act: Optional[int] = None
    jm_act: Optional[int] = None

    # -- mode switches (pom.nml_dist:28-51) --
    mode: int = 3          # 2: 2-D only, 3: full 3-D, 4: 3-D with frozen T/S
    nadv: int = 1          # 1: central tracer advection, 2: Smolarkiewicz MPDATA
    nitera: int = 1        # MPDATA corrective iterations (1-4)
    sw: float = 0.5        # MPDATA smoothing parameter (0, 1]
    npg: int = 1           # pressure gradient: 1 2nd-order, 2 McCalpin 4th-order

    # -- time stepping --
    dte: float = 6.0       # external (2-D) time step [s]
    isplit: int = 30       # dti = dte * isplit
    days: float = 0.05     # run duration [days]
    prtd1: float = 0.1     # initial print interval [days]
    prtd2: float = 1.0     # final print interval [days]
    swtch: float = 9999.0  # time [days] to switch prtd1 -> prtd2
    write_rst: float = 1.0 # restart write interval [days]

    # -- physical constants (initialize.f:80-168 defaults) --
    lramp: bool = False    # inertial ramp on wind stress / baroclinic forcing
    rhoref: float = 1025.0
    tbias: float = 0.0
    sbias: float = 0.0
    grav: float = 9.806
    kappa: float = 0.4
    z0b: float = 0.01
    cbcmin: float = 0.0025
    cbcmax: float = 1.0
    horcon: float = 0.1    # Smagorinsky coefficient
    tprni: float = 0.1     # inverse horizontal turbulent Prandtl number
    umol: float = 2.0e-5   # background vertical viscosity/diffusivity
    vmaxl: float = 100.0   # blow-up detector threshold on |vaf|
    slmax: float = 2.0
    ntp: int = 2           # Jerlov water type (1-5)
    nbct: int = 1          # surface T boundary condition (1-4, proft)
    nbcs: int = 1          # surface S boundary condition (1 or 3)
    ispadv: int = 1        # external-mode advective term update interval
    smoth: float = 0.10    # Asselin filter constant
    alpha: float = 0.0     # surface-slope weighting in external mode
    aam_init: float = 0.0  # initial horizontal viscosity
    small: float = 1.0e-9

    # -- boundary condition selection --
    # The reference hardwires Orlanski (bcondorl) for idx 3 and 5 and the
    # file-driven set (bcond) for idx 1, 2, 4, 6 (advance.f:398,464 vs
    # 231,290,442,414).  `bc_scheme` selects per-index families:
    #   "extpom"  — the reference's active mix (bcond 1,2,4,6 + bcondorl 3,5)
    #   "file"    — bcond for everything (file-driven open boundaries)
    #   "orlanski"— bcondorl for everything (seamount-style radiation)
    bc_scheme: str = "extpom"
    # Open-boundary flags rfe/rfw/rfn/rfs (Flather radiation weights,
    # bounds_forcing.f:43-83); initial_conditions sets all to 1
    # (initialize.f:442-445).
    rfe: float = 1.0
    rfw: float = 1.0
    rfn: float = 1.0
    rfs: float = 1.0

    # -- feature gates not in the reference namelist --
    do_restore: bool = False   # interior T/S restoring (restore_interior)
    calc_wr: bool = False      # include physical vertical velocity wr in
                               # output snapshots (realvertvl, advance.f:534;
                               # computed on demand at output time instead of
                               # every step — identical output values)

    # -- numerics --
    dtype: str = "float32"     # compute dtype ("float32" in production,
                               # "float64" for validation)

    # -- schedule tuning (performance-only; bit-identical results) --
    # Unroll factor for the Thomas sweeps over k (lax.scan in ops.vertical):
    # kb is small and static, so full unroll turns 2*(kb-1) sequential loop
    # dispatches per solve into straight-line code XLA can fuse.  Values
    # above kb clamp to full unroll.
    scan_unroll: int = 1024
    # Unroll factor for the isplit external-mode substeps (lax.fori_loop in
    # core.stepper); must divide isplit when > 1.
    ext_unroll: int = 1
    # Chunked halo-ring external loop inside shard_map local mode
    # (mesh/extchunk.py): one width-C*ext_halo_sub ring exchange per C
    # substeps instead of a ppermute per shifted read.  "auto" enables it
    # whenever the step runs under shard_map; "off" keeps per-read
    # exchanges.
    ext_local_chunk: str = "auto"
    extwin_chunk: int = 10     # cap on C (clipped to a divisor of isplit
                               # and to the local block's extent)
    # HBM budget for device-staged forcing series (forcing/device.py):
    # when a provider's full record series exceeds this, run_segment
    # stages only the record window each segment needs and re-stages
    # between segments (the reference streams one record pair,
    # bounds_forcing.f:607-613).
    forcing_hbm_mb: int = 512
    # Trivial 1x1 shard_map meshes: the local block IS the whole domain,
    # so the explicit local-ctx machinery (traced block offsets in every
    # region mask, O(volume) full-field edge writes) buys nothing — it is
    # the analogue of exchange2d_mpi degenerating to no-op sends at
    # n_proc=1 (parallel_mpi.f:154-351).  "auto" (default) runs the
    # single-device global machine inside the shard_map body at a 1x1
    # mesh (bitwise-identical results); "local" keeps the explicit
    # machinery (tools/meshbench.py prices it on one card).
    trivial_shardmap: str = "auto"
    ext_halo_sub: int = 3      # halo cells consumed per substep (rho).
                               # The substep's true carry-stencil radius is
                               # 2 (flux->elf radius 1; advave/uaf chains
                               # radius 2), verified numerically for both
                               # bc schemes; 3 leaves one cell of margin.

    # ------------------------------------------------------------------
    # derived quantities (read_input, initialize.f:177-191)
    # ------------------------------------------------------------------
    @property
    def dti(self) -> float:
        return self.dte * float(self.isplit)

    @property
    def dte2(self) -> float:
        return self.dte * 2.0

    @property
    def dti2(self) -> float:
        return self.dti * 2.0

    @property
    def iend(self) -> int:
        return max(int(round(self.days * 86400.0 / self.dti)), 2)

    @property
    def iprint(self) -> int:
        return max(int(round(self.prtd1 * 86400.0 / self.dti)), 1)

    @property
    def iswtch(self) -> int:
        return int(round(self.swtch * 86400.0 / self.dti))

    @property
    def iprint2(self) -> int:
        """Print interval after the iswtch switch (advance.f:65-68)."""
        return max(int(round(self.prtd2 * 86400.0 / self.dti)), 1)

    @property
    def irestart(self) -> int:
        return max(int(round(self.write_rst * 86400.0 / self.dti)), 1)

    @property
    def ispi(self) -> float:
        return 1.0 / float(self.isplit)

    @property
    def isp2i(self) -> float:
        return 1.0 / (2.0 * float(self.isplit))

    @property
    def kbm1(self) -> int:
        return self.kb - 1

    @property
    def kbm2(self) -> int:
        return self.kb - 2

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.mode not in (2, 3, 4):
            raise ValueError(f"invalid mode {self.mode}")
        if self.nadv not in (1, 2):
            raise ValueError(f"invalid nadv {self.nadv}")
        if self.npg not in (1, 2):
            raise ValueError(f"invalid npg {self.npg}")
        if self.nbcs not in (1, 3):
            raise ValueError("only nbcs in (1, 3) allowed for salinity")
        if not 1 <= self.ntp <= 5:
            raise ValueError(f"invalid Jerlov water type ntp={self.ntp}")
        if self.bc_scheme not in ("extpom", "file", "orlanski"):
            raise ValueError(f"invalid bc_scheme {self.bc_scheme}")
        if self.trivial_shardmap not in ("auto", "local"):
            raise ValueError(
                f"invalid trivial_shardmap {self.trivial_shardmap}")
        if self.kb < 3 or self.im < 5 or self.jm < 5:
            raise ValueError("domain too small")
        if self.im_act is not None and not 5 <= self.im_act <= self.im:
            raise ValueError("im_act out of range")
        if self.jm_act is not None and not 5 <= self.jm_act <= self.jm:
            raise ValueError("jm_act out of range")

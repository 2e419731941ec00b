"""extpom_tpu — a sigma-coordinate ocean dynamical core in JAX.

A JAX/XLA framework with the capabilities of the reference Fortran+MPI
model extPOM/sbPOM (see SURVEY.md): 3-D primitive equations on an
Arakawa C-grid, mode-split leapfrog time stepping (external barotropic 2-D
mode + internal baroclinic 3-D mode) with Asselin filtering, central and
Smolarkiewicz MPDATA tracer advection, 2nd/4th-order baroclinic pressure
gradients, Smagorinsky lateral mixing, Mellor-Yamada 2.5 turbulence closure
with implicit tridiagonal vertical solves, open lateral boundaries with
file-driven forcing, interior restoring, and seamless checkpoint/restart.

Design notes (a re-design for accelerators, not a port):

* All model state lives in a single immutable :class:`~extpom_tpu.core.state.State`
  pytree (replacing the reference's COMMON blocks, pom.h_dist:216-450); the
  whole internal step, including the ``isplit`` external substeps, is one
  jitted pure function (``lax.fori_loop`` over the external mode).
* Ops are written on *global* arrays with shifted-slice stencils.  Under
  ``jax.jit`` with a :class:`jax.sharding.NamedSharding` over a 2-D device
  mesh, XLA's SPMD partitioner turns the shifted slices into 1-cell
  (2-cell for the McCalpin PG) halo collective-permutes between devices,
  replacing the reference's hand-written ``exchange2d/3d_mpi``
  (parallel_mpi.f:154-480); ``mesh.shardmap`` is the explicit
  alternative.  tests/test_sharding.py and tests/test_shardmap.py hold
  both to the single-device path.
* Vertical implicit solves (profq/proft/profu/profv, solver.f:1212-1877) are
  Thomas-algorithm ``lax.scan``s over the leading k axis, vectorized over the
  full (im, jm) slab per scan step.
* I/O is chunked Zarr-compatible storage via TensorStore
  (``extpom_tpu.io``), replacing collective PnetCDF (io_pnetcdf.F).

Array conventions
-----------------
* 2-D horizontal fields: shape ``(im, jm)`` indexed ``[i, j]``.
* 3-D fields: shape ``(kb, im, jm)`` indexed ``[k, i, j]`` (k outermost so
  vertical scans stride over contiguous (im, jm) slabs; j is the
  contiguous axis).
* Vertical 1-D arrays (z, zz, dz, dzz): shape ``(kb,)``.
* Boundary arrays: west/east sides ``(jm,)`` / ``(kb, jm)``; north/south
  sides ``(im,)`` / ``(kb, im)``.
* Fortran 1-based index ``a(i,j)`` maps to 0-based ``a[i-1, j-1]``; loop
  bounds like ``do i=2,imm1`` map to the slice ``1:-1``.
"""

__version__ = "0.1.0"

from extpom_tpu.core.config import Config
from extpom_tpu.core.grid import Grid
from extpom_tpu.core.state import State, Forcing
from extpom_tpu.core.model import Model

__all__ = ["Config", "Grid", "State", "Forcing", "Model", "__version__"]

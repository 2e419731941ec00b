"""The vertical Thomas solve (ops.vertical._solve) against a dense banded
solve, on randomized inputs, for every (k0, k_last, bottom-row) variant
the four vertical solvers use — through both of its branches: the
``lax.scan`` sweeps (``scan_unroll=1``) and the straight-line full unroll
(the default ``scan_unroll``)."""

import numpy as np
import pytest
from scipy.linalg import solve_banded

import jax.numpy as jnp

from extpom_tpu.core.config import Config
from extpom_tpu.ops.vertical import _solve


IM, JM, KB = 13, 17, 9


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(5)


def _dense_solution(a, c, den, rhs, ee0, gg0, cl, rb, db, mask, k0, k_last):
    """Column by column: the tridiagonal system the sweeps solve, for the
    unknowns f[k0-1..k_last]:

    * seed row:   f[k0-1] - ee0 f[k0] = gg0
    * k0 <= k < k_last:
                  c[k] f[k-1] + (den[k] - a[k] - c[k]) f[k] + a[k] f[k+1]
                  = -rhs[k]
    * bottom row: -cl f[k_last-1] + (cl + db) f[k_last] = rb

    rows outside k0-1..k_last are zero, and masked columns are zero."""
    n = k_last - k0 + 2
    out = np.zeros((KB, IM, JM))
    for i in range(IM):
        for j in range(JM):
            ab = np.zeros((3, n))          # upper, diagonal, lower bands
            b = np.zeros(n)
            ab[1, 0], ab[0, 1], b[0] = 1.0, -ee0[i, j], gg0[i, j]
            for r, k in enumerate(range(k0, k_last), start=1):
                ab[2, r - 1] = c[k, i, j]
                ab[1, r] = den[k, i, j] - a[k, i, j] - c[k, i, j]
                ab[0, r + 1] = a[k, i, j]
                b[r] = -rhs[k, i, j]
            ab[2, n - 2] = -cl[i, j]
            ab[1, n - 1] = cl[i, j] + db[i, j]
            b[n - 1] = rb[i, j]
            out[k0 - 1:k_last + 1, i, j] = solve_banded((1, 1), ab, b)
    return out * mask


@pytest.mark.parametrize("k0,k_last,use_cl,use_mask", [
    (1, KB - 2, True, False),    # proft shape
    (1, KB - 2, True, True),     # profu/profv shape
    (1, KB - 1, False, False),   # profq q2 shape
    (2, KB - 1, False, False),   # profq q2l shape
])
def test_thomas_matches_scan(rng, k0, k_last, use_cl, use_mask):
    r3 = lambda s=1.0, o=0.0: o + s * rng.random((KB, IM, JM))
    r2 = lambda s=1.0, o=0.0: o + s * rng.random((IM, JM))
    a = -r3(0.5, 0.1)
    c = -r3(0.5, 0.1)
    den = r3(0.2, 1.0)
    rhs = r3(2.0, -1.0)
    ee0, gg0 = r2(0.5), r2(1.0)
    cl = a[k_last] if use_cl else np.zeros((IM, JM))
    rb = r2(1.0)
    db = r2(0.5, -1.5) if use_cl else np.ones((IM, JM))
    mask = ((rng.random((IM, JM)) > 0.3).astype(float) if use_mask
            else np.ones((IM, JM)))

    want = _dense_solution(a, c, den, rhs, ee0, gg0, cl, rb, db, mask,
                           k0, k_last)
    args = [jnp.asarray(x) for x in (a, c, den, rhs, ee0, gg0, cl, rb, db,
                                     mask)]
    for unroll in (1, Config.scan_unroll):
        cfg = Config(im=IM, jm=JM, kb=KB, dtype="float64",
                     scan_unroll=unroll)
        got = np.asarray(_solve(cfg, *args, k0=k0, k_last=k_last))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=f"scan_unroll={unroll}")

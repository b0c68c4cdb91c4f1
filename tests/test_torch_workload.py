"""The port's ``serving/workload.poisson_workload`` against the
reference's: the same ``np.random.default_rng`` seed for each package,
the same arguments, and the arrival times and output lengths exactly
equal (both draw from numpy in the same order, so no tolerance)."""
import numpy as np
import pytest

from repro.serving import workload as jwl
from repro_torch.serving import workload as twl


@pytest.mark.parametrize("seed,n_req,kw", [
    (0, 64, {}),
    (7, 33, dict(mean_gap_s=0.5, new_tokens=(4, 40), tail_frac=0.6)),
    (123, 1, dict(mean_gap_s=1e-3, new_tokens=(16, 256), tail_frac=0.0)),
    (5, 200, dict(tail_frac=1.0)),
])
def test_poisson_workload_matches_reference(seed, n_req, kw):
    got_arr, got_len = twl.poisson_workload(np.random.default_rng(seed),
                                            n_req, **kw)
    ref_arr, ref_len = jwl.poisson_workload(np.random.default_rng(seed),
                                            n_req, **kw)
    assert got_arr.shape == (n_req,) and got_len.shape == (n_req,)
    np.testing.assert_array_equal(got_arr, ref_arr)
    np.testing.assert_array_equal(got_len, ref_len)
    assert got_len.dtype == ref_len.dtype
    assert np.all(np.diff(got_arr) > 0)
    lo, hi = kw.get("new_tokens", (8, 128))
    assert np.all(((got_len >= lo) & (got_len <= lo + 8))
                  | ((got_len >= hi - 28) & (got_len <= hi)))

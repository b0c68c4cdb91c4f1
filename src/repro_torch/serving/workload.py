"""Open-loop serving workload generators (the reference's
``serving/workload.py``).

One definition of the "mixed-length Poisson" workload, so a latency
measurement and the serving example draw the same distribution:
exponential inter-arrival gaps and a long-tailed output-length mix, most
requests short and a minority near the cap, the regime where cohort
scheduling blocks short requests behind long ones. numpy, so the draws
from one ``np.random.Generator`` are the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np


def poisson_workload(rng, n_req, *, mean_gap_s=0.02, new_tokens=(8, 128),
                     tail_frac=0.3):
    """Returns (arrival times (n,), max_new_tokens (n,)) numpy arrays.

    ``new_tokens = (lo, hi)``: short requests draw from [lo, lo+8], long
    ones (fraction ``tail_frac``) from [hi-28, hi].
    """
    arrivals = np.cumsum(rng.exponential(mean_gap_s, size=n_req))
    lo, hi = new_tokens
    lens = np.where(rng.random(n_req) >= tail_frac,
                    rng.integers(lo, lo + 9, size=n_req),
                    rng.integers(hi - 28, hi + 1, size=n_req))
    return arrivals, lens

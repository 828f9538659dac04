"""A run with its timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped, the rest of a run driven on the CPU
at n=16, once for each fault a cell can have.  (A one-card cell has no
exchange between cards to leave out; a one-slice request has no batch to
halve.)"""

import time

import pytest
import torch

from gpubench.lib import runner
from gpubench.tests.tiny import tiny_cell


def _state_unchanged(mp):
    """Each Arnoldi step returns the basis and Hessenberg as it found them."""
    from hybrid_gmres_tpu_torch.krylov.arnoldi import ArnoldiState
    from hybrid_gmres_tpu_torch.solvers import batched, common

    mp.setattr(batched, "_batched_cgs2", lambda Qb, Hb, Wb, k, active,
               red=None: torch.zeros(Qb.shape[0], dtype=torch.bool))
    mp.setattr(common, "arnoldi_step", lambda mv, Q, H, k, tol=0.0,
               active=None: ArnoldiState(Q, H, torch.zeros((),
                                                           dtype=torch.bool)))


def _half_batch(mp):
    """The frame's first half solved, its second half filled from it."""
    import hybrid_gmres_tpu_torch.solvers as solvers

    inner = solvers.ba_gmres_batched

    def half(A, B, b, **kw):
        res = inner(A, B, b[:, :b.shape[1] // 2], **kw)
        return res._replace(x=torch.cat([res.x, res.x], dim=1),
                            res_hist=torch.cat([res.res_hist] * 2, dim=1))

    mp.setattr(solvers, "ba_gmres_batched", half)


def _answer_altered(mp, entry):
    """One pixel of each solution moved by twice the solution's norm."""
    import hybrid_gmres_tpu_torch.solvers as solvers

    inner = getattr(solvers, entry)

    def altered(*args, **kw):
        res = inner(*args, **kw)
        x = res.x.clone()
        x[0] += 2 * torch.linalg.vector_norm(x)
        return res._replace(x=x)

    mp.setattr(solvers, entry, altered)


CASES = [
    ("ct128_int8.frame8", "state unchanged", _state_unchanged),
    ("ct128_int8.frame8", "half the batch", _half_batch),
    ("ct128_int8.frame8", "answer altered",
     lambda mp: _answer_altered(mp, "ba_gmres_batched")),
    ("ct128_int8.rtp1", "state unchanged", _state_unchanged),
    ("ct128_int8.rtp1", "answer altered",
     lambda mp: _answer_altered(mp, "ab_gmres_rtp")),
    ("ct128_bf16.rtp1", "state unchanged", _state_unchanged),
    ("ct128_bf16.rtp1", "answer altered",
     lambda mp: _answer_altered(mp, "ab_gmres_rtp")),
]


@pytest.mark.parametrize("cell, fault, plant", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_fault_reads_incorrect(monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    result, judged = runner.run_cell(tiny_cell(cell), 2 ** 31 + 9, 0.3,
                                      False, "cpu", time.perf_counter(),
                                      log=lambda m: None)
    assert not result["correct"], judged
    assert not all(c["ok"] for c in judged.values())

"""The plain reference against the port on the CPU at n=16: the same
matrices, the same stored values, and the same answers within each cell's
limits."""

import numpy as np
import pytest
import torch

from gpubench.lib import runner, spec
from gpubench.reference import assemble, operators
from gpubench.tests.tiny import TINY, tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _cfg():
    return dict(spec.config("ct128_int8"), **TINY)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_assembly_matches_the_port(backend):
    from hybrid_gmres_tpu_torch.problems.ct import ct_mismatched

    cfg = _cfg()
    A, B = assemble.ct_pair(cfg, "cpu")
    prob = ct_mismatched(n=16, n_angles=24, n_det=24, backend=backend)
    for ref, port in ((A, prob.A_csr), (B, prob.B_csr)):
        assert ref.values().numel() == port.nnz
        assert np.abs(ref.to_dense().numpy() - port.toarray()).max() \
            <= 1e-12 * np.abs(port.data).max()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantization_matches_the_port(dtype):
    from hybrid_gmres_tpu_torch.ops.spmv_cuda import _row_quantize_csr

    A, _ = assemble.ct_pair(_cfg(), "cpu")
    ref = operators.stored(A, dtype).to_dense().numpy()
    import scipy.sparse as sp

    csr = sp.csr_matrix(A.to_dense().numpy().astype(np.float32))
    q, s = _row_quantize_csr(csr, qmax=operators.QMAX[dtype])
    port = (q.multiply(s.astype(np.float64)[:, None])).toarray()
    assert np.array_equal(ref, port)


def test_bfloat16_rounding():
    A, _ = assemble.ct_pair(_cfg(), "cpu")
    v = operators.stored(A, "bfloat16").values()
    assert torch.equal(v, A.values().float().bfloat16().double())


@pytest.mark.parametrize("cell", CELLS)
def test_port_cpu_path_within_the_cell_limits(cell):
    import time

    result, judged = runner.run_cell(tiny_cell(cell), 2 ** 31 + 3, 0.3,
                                      False, "cpu", time.perf_counter(),
                                      log=lambda m: None)
    assert result["correct"], judged

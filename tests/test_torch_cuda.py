"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.models import EGNNFusedModel
from geometric_message_passing_tpu_torch.ops import edge

# f32 sums in another order (the kernel's K-loop and CSR rows against the
# plain version's matmuls and index_add_)
ATOL = RTOL = 1e-4


@pytest.fixture
def cuda_device():
    """The card, with TF32 off so the plain version is exact f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _inputs(n, e, d, seed, masked, index_dtype, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e) >= masked,
        rng.normal(size=(n, d)).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32),
        (rng.normal(size=(edge.msg_rows(d), d)) * 0.1).astype(np.float32),
    )
    send, recv, emask, h, pos, w = (torch.from_numpy(a).to(device)
                                    for a in arrays)
    return (send.to(index_dtype), recv.to(index_dtype), emask, h, pos, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d,masked,index_dtype", [
    (40, 150, 32, 0.1, torch.int32),
    (808, 1408, 128, 0.15, torch.int32),
    (10_000, 129_000, 128, 0.0, torch.int32),
    (17, 33, 16, 0.3, torch.int64),        # E not a multiple of the tile
    (50, 301, 256, 0.1, torch.int64),      # widest D: 82 KB of shared memory
    (6, 0, 48, 0.0, torch.int32),          # no edges
])
def test_kernel_matches_plain(cuda_device, n, e, d, masked, index_dtype):
    args = _inputs(n, e, d, seed=8, masked=masked, index_dtype=index_dtype,
                   device=cuda_device)
    before = edge.egnn_message.launches
    with torch.no_grad():
        first = edge.egnn_message(*args)
        second = edge.egnn_message(*args)
        want = edge.egnn_message_plain(*args)
    torch.cuda.synchronize()
    assert edge.egnn_message.launches == before + 2
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)       # deterministic: no atomics
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_width(cuda_device):
    args = _inputs(10, 20, 24, seed=0, masked=0.0, index_dtype=torch.int32,
                   device=cuda_device)
    with pytest.raises(ValueError):
        edge.egnn_message(*args)


@pytest.mark.cuda
def test_predictor_on_card_matches_cpu(cuda_device):
    graphs = datasets.create_star_graphs(num=30, fold=(4, 5, 6), seed=2)
    kw = dict(num_layers=2, emb_dim=32, in_dim=1, out_dim=2, pool="mean")
    gpu = EGNNFusedModel(**kw, generator=torch.Generator().manual_seed(1),
                         device=cuda_device)
    cpu = EGNNFusedModel(**kw, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    before = edge.egnn_message.launches
    y = Predictor(gpu, batch_size=8).predict(graphs)
    assert edge.egnn_message.launches == before + 4 * 2
    y_cpu = Predictor(cpu, batch_size=8, device="cpu").predict(graphs)
    np.testing.assert_allclose(y, y_cpu, atol=ATOL, rtol=RTOL)

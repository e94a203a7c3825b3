"""The precision policy and the staged engine on a card.

Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_precision.py -q
"""

import pytest
import torch

from geometric_message_passing_tpu_torch import precision as prec
from geometric_message_passing_tpu_torch.experiments import staged_check


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_highest_under_tf32_is_exact_forward_and_backward(cuda_device):
    g = torch.Generator().manual_seed(0)
    a, b, cot = (torch.randn(*s, generator=g).to(cuda_device)
                 for s in ((512, 256), (256, 384), (512, 384)))

    def run(route):
        x, y = (t.clone().requires_grad_(True) for t in (a, b))
        out = route(x, y)
        (out * cot).sum().backward()
        return out.detach(), x.grad, y.grad

    exact = run(torch.matmul)
    with prec.matmul_precision("tensorfloat32"):
        scoped = run(lambda x, y: prec.matmul(x, y, "highest"))
        tf32 = run(prec.matmul)
    for got, want in zip(scoped, exact):
        assert torch.equal(got, want)
    assert not torch.equal(tf32[0], exact[0])


@pytest.mark.cuda
def test_staged_fit_matches_the_resident_engine(cuda_device):
    read, fails = staged_check.staged_fit()
    assert not fails, fails
    assert read["launches_per_train_step"] == {"k2": 4.0, "k4": 1.0}

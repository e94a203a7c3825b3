"""``experiments/profile_train.py`` files each CUDA kernel of the port's
sources under its group by a fragment of its name: every ``__global__``
kernel of a source, named as ``torch.profiler`` shows it (demangled, with
its template arguments and parameters), lands in that source's group, so a
renamed kernel cannot drop out of the per-layer reading unseen."""

import re

import pytest

from geometric_message_passing_tpu_torch.experiments import profile_train
from geometric_message_passing_tpu_torch.ops import _build

GROUP_OF_SOURCE = {
    "egnn_message": "K1 egnn_message",
    "egnn_message_bwd": "K2 egnn_message_bwd",
    "egnn_stack": "K6 egnn_stack",
    "egnn_stack_bwd": "K6 egnn_stack",
    "edge_contract": "K7 edge_contract",
    "sorted_segsum": "K3/K4 segment sum",
}


def _kernels(source: str) -> list:
    text = (_build.CSRC / f"{source}.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(", text)


@pytest.mark.parametrize("source,group", sorted(GROUP_OF_SOURCE.items()))
def test_every_kernel_of_a_source_lands_in_its_group(source, group):
    names = _kernels(source)
    assert names, f"no kernels found in csrc/{source}.cu"
    for name in names:
        for shown in (f"void (anonymous namespace)::{name}<float, 4, 7, "
                      f"false>((anonymous namespace)::Table)",
                      f"void (anonymous namespace)::{name}<32, long long>"
                      f"(long long const*, float*, int, int)",
                      f"void {name}<8, int>(BwdArgs<int>)",
                      f"void (anonymous namespace)::{name}<__nv_bfloat16, 7>"
                      f"(float const*, __nv_bfloat16 const*, float*, int)",
                      f"{name}(float const*, int)"):
            assert profile_train._group(shown) == group, shown


def test_the_k7_kernels_are_the_ones_tfn_runs():
    """The grouped kernel (TFN's layers) and the one-group kernels."""
    assert set(_kernels("edge_contract")) == {
        "contract_ring_kernel", "contract_fwd", "contract_bwd"}


@pytest.mark.parametrize("source,kernels", [
    ("egnn_message", {"egnn_edge_kernel", "egnn_reduce_kernel"}),
    ("egnn_message_bwd", {"egnn_bwd_transpose_kernel", "egnn_bwd_edge_kernel",
                          "egnn_bwd_node_kernel", "egnn_bwd_wgrad_kernel",
                          "egnn_bwd_wsum_kernel"}),
    ("egnn_stack", {"egnn_stack_fwd_kernel"}),
    ("egnn_stack_bwd", {"egnn_stack_bwd_kernel"})])
def test_the_egnn_kernels_are_the_ones_the_groups_name(source, kernels):
    """K1's two kernels, K2's five (the transposed weight blocks; the weight
    gradient and its column sums one launch), K6's one per direction
    (templated on the tile)."""
    assert set(_kernels(source)) == kernels

"""The kernels' wrappers on any machine: what they hand the C entries, the operands they
refuse, how they read the codes those return, and the kernels' timing tool's refusal without
a card."""

import pytest
import torch

from foley_tpu_torch.ops.kernels import common
from foley_tpu_torch.ops.kernels import fused_attention as FA
from foley_tpu_torch.tools import bench_kernels


def test_table_passes_the_denoisers_tables_through():
    """fp32 contiguous [L, D] tables (what MMDiT builds) reach the kernel untouched; a [D]
    weight or a bf16 table becomes one."""
    dev = torch.device("cpu")
    table = torch.randn(7, FA.HEAD_DIM)
    assert FA._table(table, 7, dev) is table
    row = torch.randn(FA.HEAD_DIM).to(torch.bfloat16)
    got = FA._table(row, 7, dev)
    assert got.shape == (7, FA.HEAD_DIM) and got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got, row.float().expand(7, FA.HEAD_DIM))
    half = table.to(torch.bfloat16)
    assert FA._table(half, 7, dev).dtype == torch.float32


@pytest.mark.parametrize("err,raised", [(-1, ValueError), (-2, RuntimeError),
                                        (700, RuntimeError)])
def test_check_launch_raises(err, raised):
    with pytest.raises(raised):
        common.check_launch("k", err)


def test_check_launch_passes_success():
    assert common.check_launch("k", 0) is None


@pytest.mark.parametrize("case,error", [
    ("fp32", TypeError), ("last_stride_2", ValueError), ("row_stride_68", ValueError),
    ("pointer_2_bytes_off", ValueError),
])
def test_check_operand_refuses_what_a_tensor_map_cannot_read(case, error):
    x = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    if case == "fp32":
        x = x.float()
    elif case == "last_stride_2":
        x = torch.zeros(2, 8, 4, 128, dtype=torch.bfloat16)[..., ::2]
    elif case == "row_stride_68":
        x = torch.zeros(2, 8, 4, 68, dtype=torch.bfloat16)[..., :64]
    else:
        x = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    with pytest.raises(error):
        common.check_operand("x", x)


@pytest.mark.parametrize("shape", [(2, 8, 4, 64), (784, 1536), (3, 64, 192)])
def test_check_operand_takes_aligned_bf16_views(shape):
    """Contiguous operands of K1 / K2 ([B, L, H, D]) and K3 (x [M, K], w [B, K, N]), and the
    head view of a wider last dimension, as K3 reads W_b[:, :K]."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    assert common.check_operand("x", x) is None
    wide = torch.zeros(*shape[:-1], 2 * shape[-1], dtype=torch.bfloat16)[..., :shape[-1]]
    assert common.check_operand("x", wide) is None


def test_on_device_is_no_context_for_the_current_device():
    """A device without an index launches on the current one: no device switch at all."""
    ctx = common.on_device(torch.device("cuda"))
    with ctx:
        pass
    assert type(ctx).__name__ == "nullcontext"


def test_bench_attention_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_kernels.main([]) == 2
    assert capsys.readouterr().out == ""

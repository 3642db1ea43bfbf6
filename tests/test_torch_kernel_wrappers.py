"""The attention kernels' wrappers on any machine: what they hand the C entries and how
they read the codes those return, and the timing tool's refusal without a card."""

import pytest
import torch

from foley_tpu_torch.ops.kernels import fused_attention as FA
from foley_tpu_torch.tools import bench_attention


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
        FA.check_launch("k", err)


def test_check_launch_passes_success():
    assert FA.check_launch("k", 0) is None


def test_bench_attention_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_attention.main([]) == 2
    assert capsys.readouterr().out == ""

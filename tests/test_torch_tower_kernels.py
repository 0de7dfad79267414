"""The text tower's hand-written kernels against their plain versions, on
the card at the published widths (skipped without one): the causal,
variable-length latent attention at qk 192 / v 128, and the grouped expert
products and their combination, experts that receive no rows included.

    python -m pytest tests/test_torch_tower_kernels.py    # on the card
"""

import pytest
import torch

from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
from multimodal_emotion_processing_tpu_torch.ops import moe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[1], [4096], [1, 4096, 63, 64, 65, 129,
                                                  7, 1, 300]],
                         ids=["one-token", "4096", "mixed"])
def test_latent_attention_matches_the_plain_path(cuda, lengths):
    g = torch.Generator(device=cuda).manual_seed(len(lengths))
    t, h = sum(lengths), 16
    q, kv, k_pe = (torch.randn(shape, generator=g, device=cuda).bfloat16()
                   for shape in ((t, h, 192), (t, h, 256), (t, 64)))
    cu = torch.tensor([0] + lengths, device=cuda).cumsum(0).int()
    before = fa.flash_mla_varlen_kernel.launches
    got = fa.flash_mla_varlen_kernel(q, kv, k_pe, cu, max(lengths))
    want = fa.mla_varlen_plain(q, kv, k_pe, cu, n_heads=h)
    assert fa.flash_mla_varlen_kernel.launches == before + 1
    # P enters P·V rounded once to bf16 and o is stored in bf16: each
    # output is a weighted mean of N(0, 1) values, off by a few bf16 steps
    err = (got.float() - want.float()).abs().max().item()
    assert err < 2e-2, err


def _routing(t, k, n_experts, g, device):
    """A choice of k distinct experts a token among 47 of the first 48
    (expert 5 and 48 .. 63 get no row), and positive weights."""
    pool = torch.tensor([e for e in range(48) if e != 5], device=device)
    keys = torch.rand(t, len(pool), generator=g, device=device)
    choice = pool[keys.topk(k, dim=1).indices]
    w = torch.rand(t, k, generator=g, device=device) + 0.1
    return choice, w


def _skewed(t, k, n_experts, g, device):
    """A skewed choice: expert 0 for every token, expert 1 for exactly the
    first 128, the rest among experts 2 .. 40 (41 .. 63 get no row)."""
    pool = torch.arange(2, 41, device=device)
    keys = torch.rand(t, len(pool), generator=g, device=device)
    rest = pool[keys.topk(k - 1, dim=1).indices]
    choice = torch.cat([torch.zeros_like(rest[:, :1]), rest], dim=1)
    choice[:128, 1] = 1
    w = torch.rand(t, k, generator=g, device=device) + 0.1
    return choice, w


# (tokens, routing): 4,096 tokens give each used expert ~520 rows, several
# m tiles of 128 and a ragged last one; the skewed case one expert of over
# 2,000 rows, one of exactly one tile and many of none
@pytest.mark.cuda
@pytest.mark.parametrize("tokens, routing", [(1, _routing), (300, _routing),
                                             (4096, _routing),
                                             (2400, _skewed)],
                         ids=["1", "300", "4096", "skewed"])
def test_grouped_experts_match_the_loop(cuda, tokens, routing):
    e, k, d, f = 64, 6, 2048, 1408
    g = torch.Generator(device=cuda).manual_seed(tokens)
    x = torch.randn(tokens, d, generator=g, device=cuda).bfloat16()
    w13 = torch.stack([moe.interleave_gate_up(
        *(0.02 * torch.randn(2, f, d, generator=g, device=cuda)).bfloat16())
        for _ in range(e)])
    w2 = (0.02 * torch.randn(e, d, f, generator=g, device=cuda)).bfloat16()
    choice, w = routing(tokens, k, e, g, cuda)
    rows, offsets, row_w, pos, counts = moe.sort_by_expert(choice, w, e)
    if routing is _skewed:
        assert counts[0].item() > 2000 and counts[1].item() == 128
        assert counts[41:].sum().item() == 0
    else:
        assert counts[5].item() == 0 and counts[48:].sum().item() == 0
    before = [kern.launches for kern in moe.KERNELS]
    h = moe.gate_up_kernel(x, rows, offsets, w13)
    y = moe.down_kernel(h, offsets, w2, row_w)
    want = moe.routed_plain(x, rows, offsets, w13, w2, row_w)
    # h is rounded to bf16 once in each, from f32 sums taken in another
    # order: a row may differ by a bf16 step of h, then of y
    scale = want.float().abs().max().item()
    assert (y.float() - want.float()).abs().max().item() <= 1e-2 * scale

    shared = torch.randn(tokens, d, generator=g, device=cuda).bfloat16()
    base = torch.randn(tokens, d, generator=g, device=cuda)
    got = moe.combine_kernel(base.clone(), y, pos, shared)
    expect = moe.combine_plain(base.clone(), y, pos, shared)
    assert torch.equal(got, expect)
    # one launch a call of each: gate-up, down, combine
    assert [kern.launches for kern in moe.KERNELS] == [n + 1 for n in before]


@pytest.mark.cuda
def test_tower_on_the_card_refuses_other_than_bf16(cuda):
    import dataclasses

    from multimodal_emotion_processing_tpu_torch.models.tower import TOWERS, Tower

    cfg = dataclasses.replace(TOWERS["moonlight_16b_a3b"], num_hidden_layers=2,
                              vocab_size=64)
    tower = Tower(cfg, dtype=torch.float32).to(cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    cu = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    pos = torch.arange(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tower(ids, cu, pos, 4)

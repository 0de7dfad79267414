"""The text tower (models/tower.py) on the CPU at a small size with seeded
random weights: against its plain reference (models/tower_reference.py),
packed against one sequence at a time, the router's choice, the head crop
against data/masking.summary_masking, and the pair ensemble reading its
text from the tower."""

import dataclasses

import numpy as np
import pytest
import torch

from multimodal_emotion_processing_tpu_torch import configs
from multimodal_emotion_processing_tpu_torch.data import masking, synthetic
from multimodal_emotion_processing_tpu_torch.models import tower as T
from multimodal_emotion_processing_tpu_torch.models import tower_reference as R

#: hidden 64, 4 heads, qk 16 + 8 rope, v 16, kv LoRA 32, 8 experts top 2
#: plus 1 shared, 3 layers the first dense
SMALL = dataclasses.replace(
    T.TOWERS["moonlight_16b_a3b"], num_hidden_layers=3, hidden_size=64,
    vocab_size=1000, num_attention_heads=4, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    intermediate_size=96, n_routed_experts=8, num_experts_per_tok=2,
    moe_intermediate_size=32, n_shared_experts=1)
LENGTHS = [5, 1, 17, 9]


def weight(name, shape):
    g = torch.Generator().manual_seed(sum(map(ord, name)) * 7919 % (2**31))
    n = torch.randn(shape, generator=g)
    if name.endswith("norm.weight"):
        return 1 + 0.1 * n
    if name.endswith("e_score_correction_bias"):
        return 0.05 * n
    return 0.2 * n


def small_tower(dtype=torch.float32):
    with torch.device("meta"):
        tower = T.Tower(SMALL, dtype=dtype)
    tower.to_empty(device="cpu")
    tower.fill(weight)
    return tower


def sequences(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.integers(0, SMALL.vocab_size, n)) for n in lengths]


def packed(seqs):
    lens = [len(s) for s in seqs]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32)
    pos = torch.cat([torch.arange(n) for n in lens]).int()
    return torch.cat(seqs).int(), cu, pos, max(lens)


def test_published_settings():
    c = T.TOWERS["moonlight_16b_a3b"]
    assert (c.num_hidden_layers, c.hidden_size, c.vocab_size,
            c.n_routed_experts, c.num_experts_per_tok, c.n_shared_experts,
            c.moe_intermediate_size, c.intermediate_size, c.kv_lora_rank,
            c.qk_head_dim, c.v_head_dim) == (27, 2048, 163840, 64, 6, 2, 1408,
                                             11264, 512, 192, 128)
    names = T.weight_shapes(c)
    assert len(names) == 2 + 10 + 26 * (12 + 3 * 64)
    held = sum(int(np.prod(s)) for _, s in names)
    assert abs(held / 1e9 - 15.62) < 0.01     # without the output head


def test_tower_matches_reference():
    tower = small_tower()
    seqs = sequences()
    got = tower(*packed(seqs))
    want = torch.cat(R.forward(SMALL, weight, seqs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item()


def test_chosen_experts_are_the_references(monkeypatch):
    tower = small_tower()
    seqs = sequences(seed=3)
    got = []
    real = T.TowerLayer.route

    def route(self, h):
        out = real(self, h)
        got.append(out[0])
        return out

    monkeypatch.setattr(T.TowerLayer, "route", route)
    tower(*packed(seqs))
    want = []
    R.forward(SMALL, weight, seqs, choices=want)
    n_moe = SMALL.n_moe_layers
    for li in range(n_moe):
        ref = torch.cat([want[li * len(seqs) + j] for j in range(len(seqs))])
        assert torch.equal(got[li].sort(dim=1).values, ref.sort(dim=1).values)


def test_packed_batch_equals_one_sequence_at_a_time():
    tower = small_tower()
    seqs = sequences(seed=1)
    whole = tower(*packed(seqs))
    one = torch.cat([tower(*packed([s])) for s in seqs])
    assert (whole - one).abs().max().item() < 1e-5
    stats = tower.stats().snapshot()
    assert stats["sequences"] == 2 * len(seqs)
    assert stats["tokens"] == 2 * sum(LENGTHS)
    assert stats["routed"].sum() == 2 * sum(LENGTHS) * SMALL.num_experts_per_tok \
        * SMALL.n_moe_layers


def test_correction_bias_changes_the_choice_not_the_weights():
    layer = small_tower().layers[1]
    h = torch.randn(40, SMALL.hidden_size, generator=torch.Generator().manual_seed(4))
    scores = torch.sigmoid(h @ layer.router.t())
    base_choice, _ = layer.route(h)
    layer.bias[3] = 10.0
    choice, w = layer.route(h)
    assert bool((choice == 3).any(dim=1).all())
    assert not torch.equal(choice, base_choice)
    chosen = scores.gather(1, choice)
    want = chosen / chosen.sum(dim=1, keepdim=True) * SMALL.routed_scaling_factor
    assert torch.allclose(w, want, atol=1e-6)


@pytest.mark.parametrize("lens", [[[3, 9], [20, 31]], [[0, 5], [17, 1]]])
def test_head_crop_is_summary_masking(lens):
    l_len = 20
    rng = np.random.default_rng(2)
    hidden = torch.as_tensor(rng.standard_normal((120, 8)), dtype=torch.float32)
    spans = np.array([[[0, n0], [n0, n0 + n1]] for n0, n1 in lens])
    starts = np.array([0, 60])
    width = max(1, int(np.max(spans[..., 1] - spans[..., 0])))
    gather = torch.as_tensor(np.clip(starts[:, None, None] + spans[..., :1]
                                     + np.arange(width), 0, 119))
    sl = torch.as_tensor(spans[..., 1] - spans[..., 0])
    feat, mask = T.head_crop(hidden, gather, sl, l_len)
    for b in range(2):
        for s in range(2):
            a, e = starts[b] + spans[b, s, 0], starts[b] + spans[b, s, 1]
            if e == a:
                assert feat[b, s].abs().max() == 0 and mask[b, s].max() == 0
                continue
            f, m = masking.summary_masking(hidden[a:e].numpy(), l_len)
            np.testing.assert_allclose(feat[b, s].numpy(), f[0], atol=1e-6)
            np.testing.assert_array_equal(mask[b, s].numpy(), m[0])


def test_pack_restarts_positions_and_skips_padding():
    tokens = np.array([[5, 6, 7, 0], [8, 0, 0, 0], [0, 0, 0, 0]])
    spans = np.array([[[0, 1], [1, 3]], [[0, 0], [0, 1]], [[0, 0], [0, 0]]])
    ids, cu, pos, gather, lens, max_len = T.pack(tokens, [3, 1, 0], spans)
    assert ids.tolist() == [5, 6, 7, 8] and cu.tolist() == [0, 3, 4, 4]
    assert pos.tolist() == [0, 1, 2, 0] and max_len == 3
    assert lens.tolist() == [[1, 2], [0, 1], [0, 0]]
    assert gather[0, 1, :2].tolist() == [1, 2] and gather[1, 1, 0] == 3


def test_transcript_pair_sample():
    m = dataclasses.replace(configs.get("mosei_trans").model, l_dim=64)
    s = synthetic.transcript_pair_sample(np.random.default_rng(0), m,
                                         vocab_size=1000, max_tokens=512)
    n = int(s["n_tokens"])
    assert "l" not in s and s["tokens"].shape == (512,)
    assert 64 <= n <= 512 and not s["tokens"][n:].any()
    (a, b), (c, d) = s["sentences"]
    assert b == c and d == n and 8 <= b - a <= 64 and 8 <= d - c <= 64


def test_ensemble_reads_the_towers_hidden_states():
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble
    from multimodal_emotion_processing_tpu_torch.models import build_model

    exp = configs.with_overrides(configs.get("mosei_trans"), {"model": {
        "l_dim": SMALL.hidden_size, "dim": 12, "n_heads": 2, "l_len": 6,
        "v_len": 9, "a_len": 10}})
    rng = np.random.default_rng(5)
    samples = [synthetic.transcript_pair_sample(rng, exp.model, vocab_size=1000,
                                                max_tokens=160)
               for _ in range(5)]
    members = [build_model(exp, device="cpu", seed=i).eval() for i in range(2)]
    tower = small_tower()
    ens = Ensemble(members, impl="xla", tower=T.TowerFeed(tower, exp.model.l_len))
    got = ens.predict_all(Batcher(samples, 4, shuffle=False))
    seqs = [torch.as_tensor(s["tokens"][: int(s["n_tokens"])]) for s in samples]
    hidden = R.forward(SMALL, weight, seqs)
    feats, masks = [], []
    for s, h in zip(samples, hidden):
        pair = [masking.summary_masking(h[a:b].numpy(), exp.model.l_len)
                for a, b in s["sentences"]]
        feats.append(np.stack([f[0] for f, _ in pair]))
        masks.append(np.stack([m[0] for _, m in pair]))
    batch = {k: torch.as_tensor(np.stack([s[k] for s in samples]))
             for k in ("v", "v_mask", "a", "a_mask")}
    batch["l"] = torch.as_tensor(np.stack(feats))
    batch["l_mask"] = torch.as_tensor(np.stack(masks))
    with torch.no_grad():
        want = torch.stack([m(batch, impl="xla") for m in members]).mean(0)
    assert got.shape == (5, exp.model.n_emotions)
    np.testing.assert_allclose(got, want.numpy(), atol=2e-4)

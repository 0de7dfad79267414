"""PyTorch port, the model layer's combinations and the grid's other paths.

Every head x block x unify x position-embedding combination the JAX package
builds and runs (`concat_trans` and `state_transfer` over minus or
RealFormer blocks with the linear, linear_ln or conv unify; `grid_only`
over either block with the multi-resolution conv unify; each with and
without position embeddings; the grid-free `concat_linear` whatever those
fields say): the forward against JAX's `build_model(...).apply` at 2e-4
from the same weights, gates a, b, c and every LayerNorm moved off their
init; the state-dict keys equal, in order, to JAX's
`to_reference_state_dict`; `from_jax_params` loading strictly.  Every
combination JAX fails on is refused with ValueError.  Step-1 gradients
against `jax.grad` for one new combination per grid head, and one dropout
case with the same keep masks on both sides.

The grid's other paths (models/grid.py): the stacked RealFormer grid
against JAX's `stacked=True` at unequal lengths and n_layers 2 (and on a
fully masked row against JAX's unrolled path, which JAX's stacked path
misses), its gradients against the port's unrolled path, ignored at
impl="pallas"; the merged minus grid against JAX's with
`MERGED_FAST_PATH` set on both sides, forward and gradients; the split
pool against JAX's `grid_mean_max_pool`, an exact tie included.  One JAX
program per case, jitted; each case builds one tiny model."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.interop import to_reference_state_dict  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.models import grid as jgrid  # noqa: E402
from multimodal_emotion_processing_tpu.models import layers as jlayers  # noqa: E402
from multimodal_emotion_processing_tpu.ops import pooling as jpooling  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model, grid, layers  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.pooling import grid_mean_max_pool  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

F32_TOL = 2e-4
# the family whose config (and synthetic batch) each head takes
FAMILY = {"concat_trans": "mosei_trans", "state_transfer": "mosei_realformer",
          "grid_only": "robot_demo", "concat_linear": "rencecps"}
# tiny widths; unequal lengths (the stacked path pads); each family's own
# n_layers but mosei_realformer's (2 here, so a chain runs in every head)
TINY = {
    "mosei_trans": dict(l_len=4, v_len=9, a_len=7, dim=12, n_heads=2,
                        l_dim=7, v_dim=3, a_dim=5),
    "mosei_realformer": dict(l_len=5, v_len=6, a_len=4, dim=12, n_heads=2,
                             l_dim=7, v_dim=3, a_dim=5, p_len=2, n_layers=2),
    "robot_demo": dict(l_len=4, v_len=9, a_len=7, dim=12, n_heads=2,
                       l_dim=7, a_dim=5, v_dims_multires=(3, 4, 5)),
    "rencecps": dict(dim=16, l_dim=16),
}
GRID_UNIFIES = {"concat_trans": ("linear", "linear_ln", "conv"),
                "state_transfer": ("linear", "linear_ln", "conv"),
                "grid_only": ("conv_multires",)}
COMBOS = [(head, block, unify, pos)
          for head, unifies in GRID_UNIFIES.items()
          for block in ("minus", "realformer") for unify in unifies
          for pos in (False, True)]
# no grid: the block, unify and position fields are ignored, as in JAX
COMBOS += [("concat_linear", "realformer", "conv", True),
           ("concat_linear", "minus", "conv_multires", False)]
# what JAX fails on: conv_multires under the pair and paragraph heads
# (IndexError / dot_general), any other unify under grid_only (tuple @
# Array), a block JAX has no apply for
FAILING = [("concat_trans", "minus", "conv_multires", False),
           ("state_transfer", "realformer", "conv_multires", True),
           ("grid_only", "realformer", "conv", True),
           ("grid_only", "minus", "linear", False),
           ("grid_only", "realformer", "linear_ln", True),
           ("concat_trans", "no_such_block", "linear", False)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models run op by op: one intra-op thread for this module (a
    thread per core oversubscribes a host shared by test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(head, block="minus", unify="linear", pos=False, **model):
    name = FAMILY[head]
    exp = configs.get(name)
    fields = {**TINY[name], "head": head, "dropout": 0.0, **model}
    if head != "concat_linear":
        fields.update(block=block, unify=unify, use_position_embedding=pos)
    return dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                              **fields))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _perturb(params, seed):
    """Gates a, b ~ U(0.5, 1.5) and c ~ U(0.25, 1.0) (at their init of 0 a
    RealFormer block's attention would not reach the logits, nor S_prev a
    chained block's scores) and every LayerNorm moved off its init."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        x = np.asarray(x)
        if names[-1] in ("a", "b"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if names[-1] == "c":
            return rng.uniform(0.25, 1.0, x.shape).astype(np.float32)
        if any(n.startswith(("norm", "ln")) for n in names):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, jax.device_get(params))


def _batch(exp, n=3, seed=11):
    samples = synthetic.synthetic_dataset(exp.name, exp.model, n, seed=seed)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _close(got, ref, tol=F32_TOL, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _case(combo):
    """(exp, JAX model, perturbed JAX params, the port's model with them,
    a numpy batch) of one combination."""
    exp = _exp(*combo)
    jmodel = jbuild(_jexp(exp))
    params = _perturb(jmodel.init(jax.random.PRNGKey(0)), 1)
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))   # strict
    return exp, jmodel, params, model, _batch(exp)


def _jax_logits(jmodel, params, batch, **kw):
    fn = jax.jit(functools.partial(jmodel.apply, **kw))
    return np.asarray(fn(params, batch))


def _id(combo):
    head, block, unify, pos = combo
    return f"{head}-{block}-{unify}-{'pos' if pos else 'nopos'}"


@pytest.mark.parametrize("combo", COMBOS, ids=_id)
def test_forward_matches_jax(combo):
    exp, jmodel, params, model, batch = _case(combo)
    ref = _jax_logits(jmodel, params, batch, impl="xla")
    with torch.no_grad():
        got = model(_torch(batch), impl="xla")
    _close(got, ref, what=_id(combo))


@pytest.mark.parametrize("combo", COMBOS, ids=_id)
def test_state_dict_equals_jax_export(combo):
    """The keys of JAX's `to_reference_state_dict`, in its order, are
    `from_jax_params`' and the model's (which loaded them strictly), with
    the same values."""
    exp, _, params, model, _ = _case(combo)
    ref = to_reference_state_dict(params, _jexp(exp).model)
    carried = from_jax_params(params, exp.model)
    assert list(carried) == list(ref)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_minus_state_transfer_linear_ln_names_its_norms_as_jax():
    """A `state_transfer` grid of minus blocks under the `linear_ln` unify
    names each block's LayerNorm `norm1`, as JAX's export does; only
    `concat_trans` takes Ren-MME's `norm2` / `norm3`."""
    exp, _, params, model, _ = _case(("state_transfer", "minus", "linear_ln",
                                      False))
    ref = to_reference_state_dict(params, _jexp(exp).model)
    assert "feature.multimodal_blocks.0.norm1.weight" in ref
    assert "feature.multimodal_blocks.0.norm2.weight" not in ref
    assert "feature.unify_dimension.norm1.weight" in ref
    assert set(model.state_dict()) == set(ref)
    exp, _, params, model, _ = _case(("concat_trans", "minus", "linear_ln",
                                      False))
    sd = model.state_dict()
    assert "intensity.multimodal_blocks.0.norm2.weight" in sd
    assert "norm3.weight" in sd and "norm1.weight" not in sd


@pytest.mark.parametrize("combo", FAILING, ids=_id)
def test_combinations_jax_fails_on_raise_value_error(combo):
    """JAX cannot run the combination (its forward fails while tracing),
    and the port refuses to build it or carry its weights, naming the head,
    block and unify."""
    head, block, unify, _ = combo
    exp = _exp(*combo)
    jmodel = jbuild(_jexp(exp))
    with pytest.raises(Exception):
        params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        jax.eval_shape(jmodel.apply, params, _batch(exp, n=2))
    with pytest.raises(ValueError, match=f"{head}.*{block}.*{unify}"):
        build_model(exp, device="cpu")
    with pytest.raises(ValueError, match=head):
        from_jax_params({}, exp.model)


# --- step-1 gradients against jax.grad --------------------------------------

GRAD_COMBOS = [("concat_trans", "realformer", "conv", True),
               ("state_transfer", "minus", "linear_ln", False),
               ("grid_only", "minus", "conv_multires", True)]


def _jax_grads(exp, jmodel, params, batch, **kw):
    jexp = _jexp(exp)

    def loss_fn(p):
        return jeng.batch_loss(jmodel, jexp.train, p, batch, None, False,
                               "xla")

    with _jax_grid_switches(**kw):
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), from_jax_params(jax.device_get(g), exp.model)


def _port_grads(exp, model, batch, **kw):
    model.zero_grad(set_to_none=True)
    with _port_grid_switches(**kw):
        loss = engine.batch_loss(model, exp.train, _torch(batch), impl="xla")
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


def _assert_grads(got_loss, got, ref_loss, ref, what=""):
    _close(got_loss, ref_loss, what=f"{what} loss")
    for n, ref_g in ref.items():
        g = got.get(n)
        if g is None:
            # a stream's first block reads no S_prev: its gate c gets none
            assert n.endswith(".c"), (what, n)
            np.testing.assert_array_equal(np.asarray(ref_g), 0.0)
            continue
        _close(g, ref_g, what=f"{what} {n}")


@pytest.mark.parametrize("combo", GRAD_COMBOS, ids=_id)
def test_step1_gradients_match_jax(combo):
    exp, jmodel, params, model, batch = _case(combo)
    ref_loss, ref = _jax_grads(exp, jmodel, params, batch)
    loss, got = _port_grads(exp, model, batch)
    _assert_grads(loss, got, ref_loss, ref, _id(combo))


# --- one dropout case, the same keep masks on both sides ---------------------

class MaskTape:
    """The keep masks of one forward on both sides.  `jax_dropout` stands in
    for JAX's dropout (a first trace records each active site's shape,
    then each site takes its mask in order); `replay` stands in for the
    port's `keep_mask` and hands the same masks out in order."""

    def __init__(self):
        self.shapes, self.masks, self.pos, self.live = [], [], 0, None

    def jax_dropout(self, rng, x, rate, train):
        if not train or rate <= 0.0 or rng is None:
            return x
        if self.live is None:
            self.shapes.append(tuple(x.shape))
            return x
        return jnp.where(next(self.live), x / (1.0 - rate), 0.0)

    def replay(self, shape, keep, generator, device, batch_dim=0):
        assert generator is not None
        mask = self.masks[self.pos]
        assert mask.shape == tuple(shape), (self.pos, mask.shape, shape)
        self.pos += 1
        return torch.from_numpy(mask).to(device)


def _dropout_case(monkeypatch, combo, rate=0.1, **switches):
    """JAX's and the port's training loss and step-1 gradients under the
    same keep masks, with the grid switches set on both sides; and the
    tape."""
    exp = _exp(*combo, dropout=rate)
    jexp = _jexp(exp)
    jmodel = jbuild(jexp)
    params = _perturb(jmodel.init(jax.random.PRNGKey(0)), 1)
    batch = _batch(exp)
    tape = MaskTape()

    def loss_fn(p, masks):
        tape.live = None if masks is None else iter(masks)
        return jeng.batch_loss(jmodel, jexp.train, p, batch,
                               jax.random.PRNGKey(3), True, "xla")

    monkeypatch.setattr(jlayers, "dropout", tape.jax_dropout)
    with _jax_grid_switches(**switches):
        jax.eval_shape(functools.partial(loss_fn, masks=None), params)
        rng = np.random.default_rng(2)
        tape.masks = [rng.random(s) < 1.0 - rate for s in tape.shapes]
        ref_loss, ref = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                              tape.masks)
    tape.live = None
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    model.train()
    monkeypatch.setattr(layers, "keep_mask", tape.replay)
    with _port_grid_switches(**switches):
        loss = engine.batch_loss(model, exp.train, _torch(batch), impl="xla",
                                 generator=torch.Generator())
    assert tape.pos == len(tape.masks)
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    _assert_grads(float(loss.detach()), got, float(ref_loss),
                  from_jax_params(jax.device_get(ref), exp.model),
                  _id(combo))
    return tape


def test_dropout_on_a_new_pair_combination_matches_jax(monkeypatch):
    """concat_trans over minus blocks with the conv unify (whose three
    projections, like each block's two sites, draw masks) and positions:
    15 sites a grid, two grids."""
    tape = _dropout_case(monkeypatch, ("concat_trans", "minus", "conv", True))
    assert len(tape.shapes) == 2 * (3 + 9 * 2)


# --- the grid's other paths ---------------------------------------------------

class _switches:
    """Set a module's grid switches for a block, then restore them."""

    def __init__(self, module, **kw):
        self.module, self.kw, self.old = module, kw, {}

    def __enter__(self):
        for k, v in self.kw.items():
            self.old[k] = getattr(self.module, k)
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.module, k, v)


def _jax_grid_switches(**kw):
    return _switches(jgrid, **kw)


def _port_grid_switches(**kw):
    return _switches(grid, **kw)


def _clean_rows(head, batch):
    """Over the logits' leading axes, True where no modality of the row is
    fully masked (of a pair's either slot; of a paragraph's clip or any
    clip before it, which the recurrence carries): where JAX's stacked
    path keeps the unrolled semantics."""
    full = np.zeros(batch["l_mask"].shape[:-1], bool)
    for k in ("l_mask", "v_mask", "a_mask"):
        full |= batch[k].sum(-1) == 0
    if head == "concat_trans":
        return ~full.any(axis=1)
    if head == "state_transfer":
        return ~np.logical_or.accumulate(full, axis=1)
    return ~full


def _fully_masked_first_row(batch, key="l_mask"):
    """Row 0's shortest modality all zero under an all-zero mask (a no_name
    utterance): a fully masked row of every stream whose keys it is."""
    batch = {k: v.copy() for k, v in batch.items()}
    batch[key][0] = 0.0
    batch[key[0]][0] = 0.0
    return batch


STACKED = [("grid_only", "realformer", "conv_multires", True),
           ("state_transfer", "realformer", "conv", True),
           ("concat_trans", "realformer", "linear", False)]


@pytest.mark.parametrize("combo", STACKED, ids=_id)
def test_stacked_forward_matches_jax(combo):
    """At unequal lengths and n_layers 2 (the robot and paragraph heads;
    the pair head at n_layers 1), the port's stacked path against JAX's
    `stacked=True` where JAX's keeps the unrolled semantics (rows with no
    fully masked modality; see the next test), and against JAX's unrolled
    path and its own on every row."""
    exp, jmodel, params, model, batch = _case(combo)
    ref = _jax_logits(jmodel, params, batch, impl="xla")
    jstacked = _jax_logits(jmodel, params, batch, impl="xla", stacked=True)
    with torch.no_grad():
        got = model(_torch(batch), impl="xla", stacked=True)
        unrolled = model(_torch(batch), impl="xla", stacked=False)
    clean = _clean_rows(combo[0], batch)
    assert clean.any()
    _close(got.numpy()[clean], jstacked[clean], what=_id(combo))
    _close(got, ref, what=_id(combo))
    _close(got, unrolled.numpy(), what=_id(combo))


def test_stacked_fully_masked_row_keeps_the_unrolled_semantics():
    """A fully masked row of a padded stream: the port's stacked path gives
    the unrolled path's logits (JAX's unrolled too).  JAX's stacked path
    pads the mask with 0, so there the row also spreads its softmax over
    the padded zero keys and its logits move (pinned here, not copied)."""
    combo = ("concat_trans", "realformer", "linear", True)
    exp, jmodel, params, model, batch = _case(combo)
    batch = _fully_masked_first_row(batch)        # l: 4 of 9 keys, padded
    ref = _jax_logits(jmodel, params, batch, impl="xla")
    jstacked = _jax_logits(jmodel, params, batch, impl="xla", stacked=True)
    with torch.no_grad():
        got = model(_torch(batch), impl="xla", stacked=True)
    _close(got, ref)
    assert np.abs(jstacked[0] - ref[0]).max() > 1e-3   # JAX's stacked row
    _close(jstacked[1:], ref[1:])                       # the other rows agree


@pytest.mark.parametrize("combo", STACKED[:2], ids=_id)
def test_stacked_gradients_match_the_unrolled_path(combo):
    exp, _, _, model, batch = _case(combo)
    ref_loss, ref = _port_grads(exp, model, batch)
    ref = {n: g.clone() for n, g in ref.items() if g is not None}
    loss, got = _port_grads(exp, model, batch, REALFORMER_STACKED=True)
    _assert_grads(loss, got, ref_loss, ref, _id(combo))


def test_stacked_and_merged_are_ignored_off_xla(monkeypatch):
    """At every impl but "xla" the switches leave the unrolled path and its
    kernels in place (here their plain CPU versions), as in JAX."""
    def refuse(*a, **k):
        raise AssertionError("a fast path ran off impl xla")

    monkeypatch.setattr(grid.Grid, "_stacked_realformer", refuse)
    monkeypatch.setattr(grid.Grid, "_merged_minus", refuse)
    monkeypatch.setattr(grid, "MERGED_FAST_PATH", True)
    _, _, _, model, batch = _case(("grid_only", "realformer", "conv_multires",
                                   True))
    with torch.no_grad():
        a = model(_torch(batch), impl="pallas", stacked=True)
        b = model(_torch(batch), impl="pallas", stacked=False)
    assert torch.equal(a, b)
    _, _, _, model, batch = _case(("concat_trans", "minus", "linear", False))
    with torch.no_grad():
        a = model(_torch(batch), impl="pallas_fused")
    monkeypatch.setattr(grid, "MERGED_FAST_PATH", False)
    with torch.no_grad():
        assert torch.equal(a, model(_torch(batch), impl="pallas_fused"))


def test_stacked_default_and_per_call_flag(monkeypatch):
    """`stacked=None` reads REALFORMER_STACKED at the call; an explicit flag
    wins over it; minus blocks never take the stacked path."""
    calls = []
    real = grid.Grid._stacked_realformer

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(grid.Grid, "_stacked_realformer", counted)
    _, _, _, model, batch = _case(("state_transfer", "realformer", "conv",
                                   True))
    with torch.no_grad():
        model(_torch(batch))
        assert not calls
        monkeypatch.setattr(grid, "REALFORMER_STACKED", True)
        model(_torch(batch))
        assert len(calls) == 1
        model(_torch(batch), stacked=False)
        assert len(calls) == 1
        _, _, _, minus, mbatch = _case(("state_transfer", "minus", "conv",
                                        True))
        minus(_torch(mbatch), stacked=True)
        assert len(calls) == 1


MERGED = [("concat_trans", "minus", "linear", False),
          ("concat_trans", "minus", "linear_ln", True)]


@pytest.mark.parametrize("combo", MERGED, ids=_id)
def test_merged_forward_and_gradients_match_jax(combo, monkeypatch):
    exp, jmodel, params, model, batch = _case(combo)
    calls = []
    real = grid.Grid._merged_minus

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(grid.Grid, "_merged_minus", counted)
    with _jax_grid_switches(MERGED_FAST_PATH=True):
        ref = _jax_logits(jmodel, params, batch, impl="xla")
    with _port_grid_switches(MERGED_FAST_PATH=True), torch.no_grad():
        got = model(_torch(batch), impl="xla")
    assert len(calls) == 2              # the two grids of the pair head
    _close(got, ref, what=_id(combo))
    ref_loss, ref_g = _jax_grads(exp, jmodel, params, batch,
                                 MERGED_FAST_PATH=True)
    loss, got_g = _port_grads(exp, model, batch, MERGED_FAST_PATH=True)
    _assert_grads(loss, got_g, ref_loss, ref_g, _id(combo))


def test_merged_skips_chains_and_realformer(monkeypatch):
    """The merged path is the minus grid's at n_layers 1 only."""
    monkeypatch.setattr(grid.Grid, "_merged_minus", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(grid, "MERGED_FAST_PATH", True)
    for combo in (("state_transfer", "minus", "conv", True),      # 2 layers
                  ("grid_only", "realformer", "conv_multires", False)):
        _, _, _, model, batch = _case(combo)
        with torch.no_grad():
            assert torch.isfinite(model(_torch(batch), impl="xla")).all()


@pytest.mark.parametrize("path", ["merged", "stacked"])
def test_dropout_on_the_fast_paths_matches_jax(monkeypatch, path):
    """The paths' sites in JAX's order and shapes, (3, B, L, D) per target
    (per layer for the stacked path), after the unify's: the same masks on
    both sides give JAX's loss and gradients."""
    if path == "merged":
        tape = _dropout_case(monkeypatch, ("concat_trans", "minus", "conv",
                                           False), MERGED_FAST_PATH=True)
        assert len(tape.shapes) == 2 * (3 + 3 * 2)
        assert tape.shapes[3][0] == 3
    else:
        tape = _dropout_case(monkeypatch, ("state_transfer", "realformer",
                                           "conv", True),
                             REALFORMER_STACKED=True)
        assert len(tape.shapes) == 3 + 3 * 2 * 2 + 1
        assert tape.shapes[3][0] == 3


def test_split_pool_matches_jax_with_a_tie():
    """grid_mean_max_pool against JAX's: the forward, and the gradient of a
    weighted sum, where block 0's max ties exactly across l and a in one
    column (split 1/2 each by `maximum`, in both libraries) and within the
    v block in another (routed to the first row, as torch.max routes it)."""
    rng = np.random.default_rng(0)
    bl = [rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(2)]
    ba = [rng.standard_normal((2, 5, 4)).astype(np.float32) for _ in range(2)]
    bv = [rng.standard_normal((2, 4, 4)).astype(np.float32) for _ in range(2)]
    bl[0][0, 1, 2] = ba[0][0, 3, 2] = 9.0        # l and a tie
    bv[0][1, 0, 1] = bv[0][1, 2, 1] = 8.0        # a tie inside v
    w = rng.standard_normal((2, 16)).astype(np.float32)

    def jloss(bl, ba, bv):
        return jnp.sum(jpooling.grid_mean_max_pool(bl, ba, bv) * w)

    ref = np.asarray(jpooling.grid_mean_max_pool(bl, ba, bv))
    ref_g = jax.grad(jloss, argnums=(0, 1, 2))(bl, ba, bv)
    tl, ta, tv = ([torch.tensor(x, requires_grad=True) for x in xs]
                  for xs in (bl, ba, bv))
    got = grid_mean_max_pool(tl, ta, tv)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    for ts, gs in zip((tl, ta, tv), ref_g):
        for t, g in zip(ts, gs):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                       atol=1e-6)
    # beside the mean's w / 12 (12 rows in all), the max's weight: half of
    # it to each of the tied l and a rows, all of it to v's first tied row
    mean_g = w[:, :4] / 12
    tied = tl[0].grad[0, 1, 2], ta[0].grad[0, 3, 2]
    for g in tied:
        assert np.isclose(float(g) - mean_g[0, 2], 0.5 * w[0, 8 + 2])
    assert np.isclose(float(tv[0].grad[1, 0, 1]) - mean_g[1, 1], w[1, 8 + 1])
    assert np.isclose(float(tv[0].grad[1, 2, 1]), mean_g[1, 1])


@pytest.mark.parametrize("combo", [("concat_trans", "minus", "linear", False),
                                   ("state_transfer", "realformer", "conv",
                                    True)], ids=_id)
def test_split_pool_model_matches_jax(combo):
    """SPLIT_POOL on both sides: the forward against JAX's, and the
    gradients against JAX's (no exact tie in these batches)."""
    exp, jmodel, params, model, batch = _case(combo)
    with _jax_grid_switches(SPLIT_POOL=True):
        ref = _jax_logits(jmodel, params, batch, impl="xla")
    with _port_grid_switches(SPLIT_POOL=True), torch.no_grad():
        got = model(_torch(batch), impl="xla")
    _close(got, ref, what=_id(combo))
    ref_loss, ref_g = _jax_grads(exp, jmodel, params, batch, SPLIT_POOL=True)
    loss, got_g = _port_grads(exp, model, batch, SPLIT_POOL=True)
    _assert_grads(loss, got_g, ref_loss, ref_g, _id(combo))

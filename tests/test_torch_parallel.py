"""The port's data and tensor parallelism (parallel/mesh.py) against the
JAX package's mesh (parallel/mesh.py, tests/test_parallel.py): the
tensor-parallel placement of every parameter, rule for rule through the
port's key map; dp=2, tp=2 and dp=2 x tp=2 gradients on gloo ranks
spawned on the CPU equal the single-process port's in float64 to 1e-8
(sharding apart from reassociation, as tests/test_parallel.py:43-107
does), and the JAX mesh's on the 8 virtual CPU devices in f32 to 2e-4;
dropout and R-Drop over a padded batch whose shards hold different counts
of real rows; and `Ensemble(mesh=)`."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import torch_dist_common as tdc  # noqa: E402
from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.parallel import (  # noqa: E402
    batch_sharding, make_mesh as jmake_mesh, shard_params as jshard,
    tp_param_spec as jspec)
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_dataset)
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.parallel import tp_param_spec  # noqa: E402

F64_TOL = 1e-8      # tests/test_parallel.py:107
F32_TOL = 2e-4      # tests/test_interop.py:20

# tests/test_parallel.py:21-24 and :146-147
MT = dict(l_len=4, v_len=6, a_len=8, dim=24, n_heads=2, l_dim=10, v_dim=7,
          a_dim=5)
RF = dict(l_len=4, v_len=4, a_len=4, dim=24, n_heads=2, l_dim=10, v_dim=7,
          a_dim=5, p_len=2)
TINY = dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2, l_dim=5, v_dim=4,
            a_dim=3)


def jexp_of(name, model):
    exp = jconfigs.get(name)
    return dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                              **model))


def with_gates(params, value=0.3):
    """RealFormer gates a, b, c set non-zero: at their initial 0 the
    attention cannot reach the logits."""
    def put(path, x):
        key = getattr(path[-1], "key", None)
        return np.full_like(np.asarray(x), value) if key in "abc" else x

    return jax.tree_util.tree_map_with_path(put, params)


def batch_of(name, model, b, n=None, **kw):
    exp = tdc.exp_of(name, model)
    samples = synthetic_dataset(name, exp.model, b if n is None else n, 0)
    batches = list(Batcher(samples, b, shuffle=False, **kw)())
    return batches[-1]


def jax_mesh_grads(jexp, params, batch, n_data, n_model):
    """JAX's gradients of batch_loss on a (n_data, n_model) mesh of the
    virtual CPU devices, as a port state dict."""
    model = jbuild(jexp)

    def grads_of(p, b):
        return jax.grad(lambda q: jeng.batch_loss(
            model, jexp.train, q, b, None, False, "xla"))(p)

    mesh = jmake_mesh(n_data=n_data, n_model=n_model)
    sp = jshard(mesh, params, tp=n_model > 1)
    sb = jax.device_put(batch, batch_sharding(mesh, batch))
    grads = jax.device_get(jax.jit(grads_of)(sp, sb))
    return from_jax_params(grads, jexp)


def case(name, model, params, batch, mesh, dtype, **kw):
    return {"name": name, "model": model, "batch": batch, "mesh": mesh,
            "dtype": dtype,
            "state_dict": from_jax_params(params, jexp_of(name, model)), **kw}


@pytest.fixture(scope="module")
def setups():
    """The JAX weights and batches of each configuration."""
    mt = jexp_of("mosei_trans", MT)
    rf = jexp_of("mosei_realformer", RF)
    mt_params = jbuild(mt).init(jax.random.PRNGKey(0))
    rf_params = with_gates(jbuild(rf).init(jax.random.PRNGKey(1)))
    rm = jexp_of("ren_mme", TINY)
    rm_params = jbuild(rm).init(jax.random.PRNGKey(2))
    return {
        "mt": (mt, mt_params), "rf": (rf, rf_params), "rm": (rm, rm_params),
        "mt16": batch_of("mosei_trans", MT, 16),
        "mt8": batch_of("mosei_trans", MT, 8),
        "rf8": batch_of("mosei_realformer", RF, 8),
        # 5 pairs in batches of 4 pairs: the last holds 1 real pair of 4,
        # duplicated to 8 rows, so rank 1 of dp=2 holds no real row
        "rm_pad": batch_of("ren_mme", TINY, 4, n=5, duplicate=True),
    }


@pytest.fixture(scope="module")
def two_ranks(setups, tmp_path_factory):
    mt, mt_p = setups["mt"]
    rf, rf_p = setups["rf"]
    rm, rm_p = setups["rm"]
    f32, f64 = torch.float32, torch.float64
    cases = {
        "dp2_f64": case("mosei_trans", MT, mt_p, setups["mt16"], (2, 1), f64),
        "dp2_f32": case("mosei_trans", MT, mt_p, setups["mt16"], (2, 1), f32),
        "tp2_realformer_pallas_f64": case(
            "mosei_realformer", RF, rf_p, setups["rf8"], (1, 2), f64,
            impl="pallas"),
        "tp2_realformer_pallas_f32": case(
            "mosei_realformer", RF, rf_p, setups["rf8"], (1, 2), f32,
            impl="pallas"),
        "tp2_pallas_fused_f64": case("mosei_trans", MT, mt_p, setups["mt8"],
                                     (1, 2), f64, impl="pallas_fused"),
        "dp2_dropout_rdrop_padded_f64": case(
            "ren_mme", TINY, rm_p, setups["rm_pad"], (2, 1), f64,
            train_mode=True),
        "tp2_realformer_steps_f64": case(
            "mosei_realformer", RF, rf_p, setups["rf8"], (1, 2), f64,
            impl="pallas", steps=3),
    }
    members = [from_jax_params(jbuild(mt).init(jax.random.PRNGKey(s)), mt)
               for s in (3, 4)]
    ens = {"name": "mosei_trans", "model": MT, "members": members,
           "samples": synthetic_dataset("mosei_trans",
                                        tdc.exp_of("mosei_trans", MT).model,
                                        13, 5),
           "batch_size": 4}
    outs = tdc.spawn("grads", 2, tmp_path_factory.mktemp("tp2"),
                     {"cases": cases, "ensemble": ens})
    return cases, outs


@pytest.fixture(scope="module")
def four_ranks(setups, tmp_path_factory):
    mt, mt_p = setups["mt"]
    rf, rf_p = setups["rf"]
    f32, f64 = torch.float32, torch.float64
    cases = {
        "dp2xtp2_f64": case("mosei_trans", MT, mt_p, setups["mt8"], (2, 2),
                            f64),
        "dp2xtp2_f32": case("mosei_trans", MT, mt_p, setups["mt8"], (2, 2),
                            f32),
        "dp2xtp2_realformer_f64": case("mosei_realformer", RF, rf_p,
                                       setups["rf8"], (2, 2), f64),
        "dp2xtp2_steps_f64": case("mosei_trans", MT, mt_p, setups["mt8"],
                                  (2, 2), f64, steps=3),
    }
    outs = tdc.spawn("grads", 4, tmp_path_factory.mktemp("tp4"),
                     {"cases": cases})
    return cases, outs


def _close(got, ref, tol, what):
    assert set(got) == set(ref), what
    for k in ref:
        np.testing.assert_allclose(got[k].double().numpy(),
                                   ref[k].double().numpy(), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {k}")


FAMILIES = {"mosei_trans": MT, "mosei_realformer": RF, "ren_mme": TINY,
            "robot_demo": dict(dim=24, n_heads=2),
            "rencecps": dict(dim=16)}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_tp_param_spec_matches_jax(name):
    """Every parameter's placement is JAX's `tp_param_spec` through the key
    map: each JAX leaf is marked with its index, converted, and its spec
    read on the torch side (a 2-D kernel is transposed, so JAX's axis a
    is torch's dim 1 - a)."""
    jexp = jexp_of(name, FAMILIES[name])
    params = jbuild(jexp).init(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32)
                  for i, x in enumerate(leaves)])
    jspecs = jax.tree_util.tree_leaves(
        jspec(params, enable=True), is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
    sd = from_jax_params(marked, jexp)
    model = build_model(tdc.exp_of(name, FAMILIES[name]), device="cpu")
    ours = tp_param_spec(model)
    assert set(ours) == set(sd)
    sharded = 0
    for key, t in sd.items():
        spec = tuple(jspecs[int(t.reshape(-1)[0])])
        if "model" not in spec:
            want = Replicate()
        else:
            assert t.ndim == 2, key
            want = Shard(1 - spec.index("model"))
            sharded += 1
        assert ours[key] == want, (key, spec, ours[key])
    assert sharded or name == "rencecps"


def test_tp_spec_rules():
    """JAX's per-block rule (tests/test_parallel.py:123-150): a minus
    block's `proj` is column-parallel, a realformer block's row-parallel;
    a classifier shards its input axis."""
    mt = tp_param_spec(build_model(tdc.exp_of("mosei_trans", MT),
                                   device="cpu"))
    assert mt["stimulation.multimodal_blocks.0.proj.weight"] == Shard(0)
    assert mt["stimulation.multimodal_blocks.0.minus.weight"] == Shard(1)
    assert mt["stimulation.classifier.weight"] == Shard(1)
    rf = tp_param_spec(build_model(tdc.exp_of("mosei_realformer", RF),
                                   device="cpu"))
    assert rf["feature.multimodal_blocks.0.w_qkv.0.weight"] == Shard(0)
    assert rf["feature.multimodal_blocks.0.proj.weight"] == Shard(1)
    assert rf["feature.multimodal_blocks.0.ffn.0.bias"] == Replicate()
    assert rf["classifier.weight"] == Shard(1)


TWO = ["dp2_f64", "tp2_realformer_pallas_f64", "tp2_pallas_fused_f64",
       "dp2_dropout_rdrop_padded_f64"]
FOUR = ["dp2xtp2_f64", "dp2xtp2_realformer_f64"]


def _equal_single_process(outs, key):
    """Every rank's loss, whole gradients and the clip's global norm (a
    replicated gradient counted once, a shard's squares summed over
    'model') against the single process's, f64 to 1e-8."""
    single_loss, single, single_norm = outs[0][key]["single"]
    for r, out in enumerate(outs):
        loss, grads, norm = out[key]["mesh"]
        assert abs(loss - single_loss) <= F64_TOL * max(1.0, abs(single_loss))
        assert abs(norm - single_norm) <= F64_TOL * single_norm
        _close(grads, single, F64_TOL, f"{key} rank {r}")


@pytest.mark.parametrize("key", TWO)
def test_two_rank_gradients_equal_single_process(two_ranks, key):
    _equal_single_process(two_ranks[1], key)


@pytest.mark.parametrize("key", FOUR)
def test_four_rank_gradients_equal_single_process(four_ranks, key):
    _equal_single_process(four_ranks[1], key)


def _steps_equal(outs, key):
    losses, params = outs[0][key]["single"]
    for r, out in enumerate(outs):
        got_losses, got = out[key]["mesh"]
        np.testing.assert_allclose(got_losses, losses, rtol=F64_TOL)
        _close(got, params, F64_TOL, f"{key} rank {r}")


def test_four_rank_steps_equal_single_process(four_ranks):
    """Three optimizer steps at dp=2 x tp=2 (gradients summed in the flat
    buffer, the clip's norm over shards, AdamW on the shards and their
    moments) give the single process's losses and parameters, f64."""
    _steps_equal(four_ranks[1], "dp2xtp2_steps_f64")


def test_two_rank_realformer_steps_equal_single_process(two_ranks):
    """Three Adam steps of the paragraph model at tp=2 (the scored
    attention on H/2 heads a rank, the chained S head-sharded) give the
    single process's losses and parameters, f64."""
    _steps_equal(two_ranks[1], "tp2_realformer_steps_f64")


@pytest.mark.parametrize("key,jmesh", [("dp2_f32", (8, 1)),
                                       ("tp2_realformer_pallas_f32", (4, 2))])
def test_two_rank_gradients_equal_jax_mesh(two_ranks, setups, key, jmesh):
    cases, outs = two_ranks
    c = cases[key]
    jexp, params = setups["mt" if c["name"] == "mosei_trans" else "rf"]
    ref = jax_mesh_grads(jexp, params, c["batch"], *jmesh)
    _close(outs[0][key]["mesh"][1], ref, F32_TOL, key)


def test_four_rank_gradients_equal_jax_mesh(four_ranks, setups):
    cases, outs = four_ranks
    jexp, params = setups["mt"]
    ref = jax_mesh_grads(jexp, params, cases["dp2xtp2_f32"]["batch"], 4, 2)
    for out in outs:
        _close(out["dp2xtp2_f32"]["mesh"][1], ref, F32_TOL, "dp2xtp2")


def test_dropout_case_had_shards_of_unequal_real_rows(two_ranks):
    """The padded R-Drop batch gives rank 0 one real pair and rank 1 none:
    a mean of per-rank means would be wrong there."""
    cases, _ = two_ranks
    w = np.asarray(cases["dp2_dropout_rdrop_padded_f64"]["batch"]
                   ["sample_weight"])
    assert w[:4].sum() == 2 and w[4:].sum() == 0


def test_sharded_ensemble_equals_one_rank(two_ranks):
    """`Ensemble(mesh=)` at dp=2: the all-gathered logits of 13 samples in
    batches of 4 (the last padded) equal one rank's Ensemble; a batch that
    does not divide the data axis and staged prediction raise JAX's
    errors (eval/ensemble.py:84-91, :127-130)."""
    _, outs = two_ranks
    for out in outs:
        ens = out["ensemble"]
        assert ens["mesh"].shape == (13, 7)
        np.testing.assert_allclose(ens["mesh"], ens["single"], rtol=1e-6,
                                   atol=1e-6)
        assert "must divide the mesh 'data' axis (2)" in ens["odd_batch"]
        assert "does not compose with mesh=" in ens["staged"]

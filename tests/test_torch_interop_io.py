"""PyTorch port, reference `.pt` files in and out (interop/torch_compat.py,
`import-torch`, `export-torch`) on the CPU at tiny widths: a torch-oracle
state dict of each of the five families (tests/torch_reference.py, the
reference's key names, gates set non-zero) saved with `torch.save`,
imported through `cli import-torch`, gives the oracle's logits and those
of the JAX package's `load_reference_checkpoint` of the same file within
2e-4; `cli export-torch` of members built by `from_jax_params` writes the
JAX package's `to_reference_state_dict` bit for bit under the reference's
file names; importing over existing members needs --force."""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_reference as tref  # noqa: E402
from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.interop import (  # noqa: E402
    load_reference_checkpoint as jax_load, to_reference_state_dict as jax_export)
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import (  # noqa: E402
    from_jax_params, load_reference_checkpoint, to_reference_state_dict)
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402
from torch_driver_common import one_intra_op_thread  # noqa: E402,F401

TOL = 2e-4   # tests/test_interop.py:20
SMALL = dict(l_len=4, v_len=5, a_len=6, dim=12, n_heads=2, l_dim=7, v_dim=3,
             a_dim=5)
MODELS = {
    "mosei_trans": SMALL,
    "ren_mme": dict(SMALL, dim=16),
    "rencecps": dict(dim=24, l_dim=24),
    "mosei_realformer": dict(SMALL, p_len=3, n_layers=2, ffn=2),
    "robot_demo": dict(SMALL, v_dim=0, n_layers=2, ffn=2,
                       v_dims_multires=(4, 6, 8)),
}
ORACLES = {
    "mosei_trans": lambda m: tref.ConcatTrans(m, "norm1", "norm1"),
    "ren_mme": lambda m: tref.ConcatTrans(m, "norm3", "norm2"),
    "rencecps": lambda m: tref.ConcatLinear(m.dim, e=m.n_emotions),
    "mosei_realformer": tref.StateTransfer,
    "robot_demo": tref.RobotMultiClass,
}
INPUTS = {
    "concat_trans": ("l", "v", "a", "l_mask", "v_mask", "a_mask"),
    "concat_linear": ("feat",),
    "state_transfer": ("l", "v", "a", "l_mask", "v_mask", "a_mask"),
    "grid_only": ("l", "v256", "v512", "v1024", "a", "l_mask", "v_mask",
                  "a_mask"),
}


def _exps(family):
    return tuple(dataclasses.replace(
        mod.get(family), model=dataclasses.replace(mod.get(family).model,
                                                   **MODELS[family]))
        for mod in (configs, jconfigs))


def _sets(family):
    return [f"--set=model.{k}={list(v) if isinstance(v, tuple) else v}"
            .replace(" ", "") for k, v in MODELS[family].items()]


def _oracle_pt(family, m, path, seed):
    """A seeded oracle with every gate drawn from U(0.25, 1) (at 0 the
    attention would not reach the logits), saved as the reference saves."""
    torch.manual_seed(seed)
    oracle = ORACLES[family](m)
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if re.search(r"\.(a|b|c)$", name):
                p.uniform_(0.25, 1.0)
    torch.save(oracle.state_dict(), path)
    return oracle.eval()


def _batch(exp, n=3):
    return next(iter(Batcher(synthetic_dataset(exp.name, exp.model, n, seed=5),
                             n, shuffle=False)()))


@pytest.mark.parametrize("family", list(MODELS))
def test_import_torch_matches_the_oracle_and_jax(family, tmp_path):
    exp, jexp = _exps(family)
    m = exp.model
    path = str(tmp_path / f"model_1_{2.18:.4}.pt")
    oracle = _oracle_pt(family, m, path, seed=len(family))
    main(["import-torch", family, path, "--checkpoint-dir",
          str(tmp_path / "ck"), *_sets(family)])
    store = CheckpointStore(str(tmp_path / "ck"))
    assert store.best_members(family) == [f"{family}_1"]
    entry = store.manifest[f"{family}_1"]
    assert entry["valid_loss"] == 2.18 and entry["imported"]

    batch = _batch(exp)
    model = store.restore_params(f"{family}_1", build_model(exp, device="cpu"))
    with torch.no_grad():
        got = model(to_device(batch, "cpu")).numpy()
        want = oracle(*(torch.from_numpy(np.asarray(batch[k]))
                        for k in INPUTS[m.head])).numpy()
    jax_logits = np.asarray(jbuild(jexp).apply(jax_load(path, jexp.model),
                                                batch))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jax_logits, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("family", list(MODELS))
def test_export_torch_writes_jax_to_reference_state_dict(family, tmp_path):
    exp, jexp = _exps(family)
    jparams = [jax.device_get(jbuild(jexp).init(jax.random.PRNGKey(i)))
               for i in range(2)]
    store = CheckpointStore(str(tmp_path / "src"))
    for i, p in enumerate(jparams):
        model = build_model(exp, device="cpu")
        model.load_state_dict(from_jax_params(p, exp.model))
        store.save_params(f"{family}_{i + 1}", model,
                          valid_loss=(2.11, 2.12)[i], imported=False)
    paths = main(["export-torch", family, "--checkpoint-dir",
                  str(tmp_path / "src"), "--out", str(tmp_path / "pt"),
                  *_sets(family)])
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        f"{family}_1_2.11.pt", f"{family}_2_2.12.pt"]
    for path, p in zip(paths, jparams):
        got = torch.load(path, weights_only=True)
        want = jax_export(p, jexp.model)
        assert set(got) == set(want)
        for k in want:
            assert got[k].is_contiguous() and got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        # and the file loads back, strictly, into a port model
        back = load_reference_checkpoint(path, exp)
        assert all(torch.equal(v, got[k]) for k, v in
                   to_reference_state_dict(back).items())


def test_import_torch_refuses_clobber_without_force(tmp_path):
    exp, _ = _exps("rencecps")
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"model_d{i + 1}_{2.11 + i / 100:.4}.pt"))
        _oracle_pt("rencecps", exp.model, paths[-1], seed=i)
    ck = str(tmp_path / "ck")
    store = CheckpointStore(ck)
    # a trained member with a train state: a forced import must drop it
    trained = build_model(exp, device="cpu", seed=9)
    store.save_params("rencecps_1", trained, valid_loss=1.0, imported=False)
    store.manifest["rencecps_1"]["full"] = "stale.pt"
    store._write_manifest()
    with pytest.raises(SystemExit, match="--force"):
        main(["import-torch", "rencecps", *paths, "--checkpoint-dir", ck,
              *_sets("rencecps")])
    assert CheckpointStore(ck).manifest["rencecps_1"]["valid_loss"] == 1.0
    names = main(["import-torch", "rencecps", *paths, "--checkpoint-dir", ck,
                  "--force", *_sets("rencecps")])
    assert names == ["rencecps_1", "rencecps_2"]
    entry = CheckpointStore(ck).manifest["rencecps_1"]
    assert entry["imported"] and entry["valid_loss"] == 2.11
    assert "full" not in entry
    sd = CheckpointStore(ck).restore_params("rencecps_1")
    ref = torch.load(paths[0], weights_only=True)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_load_reference_checkpoint_is_strict(tmp_path):
    """A file of another width, or with a key the model lacks, raises; the
    robot reference's unused fully_connected / normalization are dropped."""
    exp, _ = _exps("robot_demo")
    path = str(tmp_path / "robot.pt")
    _oracle_pt("robot_demo", exp.model, path, seed=0)
    assert "fully_connected.weight" in torch.load(path, weights_only=True)
    load_reference_checkpoint(path, exp)
    wider = dataclasses.replace(exp.model, dim=18, n_heads=3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_reference_checkpoint(path, wider)
    sd = torch.load(path, weights_only=True)
    sd["extra.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="extra.weight"):
        load_reference_checkpoint(path, exp)

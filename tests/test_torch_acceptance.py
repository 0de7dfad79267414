"""PyTorch port, the real-corpus acceptance flow (eval/acceptance.py, the
`acceptance` command) on the CPU over miniature layout-faithful corpus
trees (tests/corpus_fixtures.py) with torch-oracle `.pt` checkpoints
(tests/torch_reference.py, gates set non-zero), the cases of
tests/test_acceptance.py, each report held against the JAX package's
`run_acceptance` on the same tree and files: MOSEI import and metrics
(equal), the robot golden demo (the reported probabilities equal, the
unrounded ones within 2e-4 of JAX's StreamingPredictor), a bad tree
(the same data check, no import, no eval), the clobber refusal,
train-from-scratch (MOSEI from the same start weights as JAX: fold losses
within 2e-4, metrics equal; robot: the golden demo on the trained
members) and its refusal of --torch-ckpts.  The MOSEI cases read `.csd`
files and skip where h5py does not import."""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as tref  # noqa: E402
from corpus_fixtures import build_mosei_tree, build_robot_tree  # noqa: E402
from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.eval import acceptance as jacc  # noqa: E402
from multimodal_emotion_processing_tpu.pipelines import load_real_data as jload  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval import acceptance  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval.acceptance import (  # noqa: E402
    GOLDEN_DEMO_EXPECTED, REFERENCE_FOLD_LOSSES, run_acceptance)
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.pipelines import load_real_data  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402
from test_torch_pipelines import _same_start  # noqa: E402
from torch_driver_common import one_intra_op_thread  # noqa: E402,F401

TOL = 2e-4   # tests/test_interop.py:20
MOSEI_OV = {
    "model": {"l_dim": 12, "v_dim": 7, "a_dim": 9, "l_len": 8, "v_len": 10,
              "a_len": 12, "dim": 24, "n_heads": 2},
    "train": {"batch_size": 8, "n_folds": 2, "fold_size": None},
}
ROBOT_OV = {
    "model": {"l_dim": 16, "a_dim": 10, "l_len": 5, "v_len": 6, "a_len": 7,
              "dim": 18, "n_heads": 3, "n_layers": 1, "ffn": 1,
              "v_dims_multires": (4, 8, 12)},
    "train": {"batch_size": 4, "n_folds": 2},
}
CLIPS = ["clip0[0]", "clip3[0]"]


def _model(name, ov):
    return dataclasses.replace(configs.get(name).model, **ov["model"])


def _save_pts(tmp_path, make_oracle, n=2, base_loss=2.18):
    """Loss-tagged .pt files ('{name}_{loss:.4}.pt', cmu-mosei/run.py:
    446-453) of independently seeded oracles, their gates drawn from
    U(0.25, 1)."""
    pts = []
    for i in range(n):
        torch.manual_seed(i)
        oracle = make_oracle()
        with torch.no_grad():
            for name, p in oracle.named_parameters():
                if re.search(r"\.(a|b|c)$", name):
                    p.uniform_(0.25, 1.0)
        path = str(tmp_path / f"model_{i + 1}_{base_loss + i / 100:.4}.pt")
        torch.save(oracle.state_dict(), path)
        pts.append(path)
    return pts


def _both(config, root, ck, **kw):
    """The port's and JAX's reports for the same tree and arguments, each
    with its own store; JAX's first (a same-start patch takes the port's
    members' weights from JAX's)."""
    jax_report = jacc.run_acceptance(config, str(root),
                                     checkpoint_dir=str(ck / "jax"), **kw)
    port = run_acceptance(config, str(root), checkpoint_dir=str(ck / "port"),
                          device="cpu", **kw)
    return port, jax_report


def _strip(report):
    """The report without its store path, the port's own module names read
    as the JAX package's (its messages name the module to run)."""
    text = json.dumps({k: v for k, v in report.items()
                       if k != "checkpoint_dir"})
    return json.loads(text.replace("multimodal_emotion_processing_tpu_torch",
                                   "multimodal_emotion_processing_tpu"))


@pytest.fixture(scope="module")
def mosei_root(tmp_path_factory):
    pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("acceptance") / "mosei"
    build_mosei_tree(root, _model("mosei_trans", MOSEI_OV), seed=0)
    return root


@pytest.fixture(scope="module")
def robot_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acceptance") / "robot"
    os.makedirs(root)
    build_robot_tree(root, _model("robot_demo", ROBOT_OV), n_clips=6, seed=4)
    return root


def test_acceptance_mosei_torch_import_and_metrics(tmp_path, mosei_root):
    pts = _save_pts(tmp_path, lambda: tref.ConcatTrans(
        _model("mosei_trans", MOSEI_OV)))
    port, jrep = _both("mosei_trans", mosei_root, tmp_path, torch_ckpts=pts,
                       overrides=MOSEI_OV)
    assert port["ok"] and port["data_check"]["ok"]
    assert port["imported_members"] == ["mosei_trans_1", "mosei_trans_2"]
    store = CheckpointStore(str(tmp_path / "port"))
    assert [store.manifest[n]["valid_loss"] for n in
            port["imported_members"]] == [2.18, 2.19]
    per = port["metrics"]["per_emotion"]
    assert set(per) == set(configs.get("mosei_trans").emotion_names)
    assert _strip(port) == _strip(jrep)


def test_acceptance_robot_golden_demo(tmp_path, robot_root):
    m = _model("robot_demo", ROBOT_OV)
    pts = _save_pts(tmp_path, lambda: tref.RobotMultiClass(m), base_loss=1.31)
    port, jrep = _both("robot_demo", robot_root, tmp_path, torch_ckpts=pts,
                       demo_clips=CLIPS, overrides=ROBOT_OV)
    demo = port["golden_demo"]
    assert port["ok"] and demo["members"] == ["robot_demo_1", "robot_demo_2"]
    assert demo["reference_expected"] == GOLDEN_DEMO_EXPECTED
    assert set(demo["clips"]) == set(CLIPS)
    assert demo["clips"] == jrep["golden_demo"]["clips"]

    # the unrounded probabilities against JAX's predictor on the same files
    from multimodal_emotion_processing_tpu.serve import (
        StreamingPredictor as JaxPredictor)
    from multimodal_emotion_processing_tpu.models import build_model as jbuild
    from multimodal_emotion_processing_tpu.interop import (
        load_reference_checkpoint as jax_load_pt)

    exp = configs.with_overrides(configs.get("robot_demo"), ROBOT_OV)
    jexp = jconfigs.with_overrides(jconfigs.get("robot_demo"), ROBOT_OV)
    store = CheckpointStore(str(tmp_path / "port"))
    members = [store.restore_params(n, build_model(exp, device="cpu"))
               for n in demo["members"]]
    sp = StreamingPredictor(members, exp.thresholds)
    jsp = JaxPredictor(jbuild(jexp), [jax_load_pt(p, jexp.model) for p in pts],
                       offsets=jexp.thresholds)
    samples, _, ctx = load_real_data(exp, str(robot_root))
    jsamples, _, jctx = jload(jexp, str(robot_root))
    by = {ctx["names"][int(s["name_idx"])]: s for s in samples}
    jby = {jctx["names"][int(s["name_idx"])]: s for s in jsamples}
    for clip in CLIPS:
        got = sp.predict(by[clip])[1]
        want = np.asarray(jsp.predict(jby[clip])[1])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_acceptance_bad_tree_fails_closed(tmp_path):
    root = tmp_path / "corpus"
    os.makedirs(root)   # empty: labels.txt and the .csd files missing
    port, jrep = _both("mosei_trans", root, tmp_path, overrides=MOSEI_OV)
    assert port["ok"] is False and port["data_check"]["problems"]
    assert "metrics" not in port and "imported_members" not in port
    assert _strip(port) == _strip(jrep)


def test_acceptance_refuses_member_clobber(tmp_path, mosei_root):
    pts = _save_pts(tmp_path, lambda: tref.ConcatTrans(
        _model("mosei_trans", MOSEI_OV)), n=1)
    kw = dict(checkpoint_dir=str(tmp_path / "ck"), torch_ckpts=pts,
              overrides=MOSEI_OV, device="cpu")
    assert run_acceptance("mosei_trans", str(mosei_root), **kw)["ok"]
    with pytest.raises(ValueError, match="force"):
        run_acceptance("mosei_trans", str(mosei_root), **kw)
    assert run_acceptance("mosei_trans", str(mosei_root), force=True,
                          **kw)["ok"]
    # the command: the same refusal as its exit
    code = None
    try:
        main(["acceptance", "mosei_trans", "--data-root", str(mosei_root),
              "--checkpoint-dir", str(tmp_path / "ck"), "--torch-ckpts",
              *pts, "--device", "cpu",
              *(f"--set=model.{k}={v}" for k, v in MOSEI_OV["model"].items()),
              "--set=train.batch_size=8", "--set=train.n_folds=2"])
    except ValueError as e:
        code = str(e)
    assert code is not None and "force" in code


def test_acceptance_train_from_scratch_mosei(tmp_path, mosei_root,
                                             monkeypatch, capsys):
    """Both frameworks train from the same start weights on the tree
    (JAX's and the port's sequential k-fold driver, the MOSEI pair units):
    the fold losses within 2e-4, the same epochs, the same metrics; the
    command writes the same report to -o."""
    _same_start(monkeypatch)
    port, jrep = _both("mosei_trans", mosei_root, tmp_path,
                       overrides=MOSEI_OV, train_from_scratch=True, epochs=2)
    tr, jtr = port["trained"], jrep["trained"]
    assert port["ok"] and len(tr["fold_best_valid_losses"]) == 2
    assert tr["epochs_ran"] == jtr["epochs_ran"]
    assert all(1 <= e <= 2 for e in tr["epochs_ran"])
    assert tr["reference_expected"] == REFERENCE_FOLD_LOSSES["mosei_trans"] \
        == jtr["reference_expected"]
    for a, b in zip(tr["fold_best_valid_losses"], jtr["fold_best_valid_losses"]):
        assert abs(a - b) <= 1e-4 + TOL * abs(b)
    assert port["metrics"] == jrep["metrics"]
    assert len(CheckpointStore(str(tmp_path / "port")).best_members(
        "mosei_trans")) == 2


def test_acceptance_train_from_scratch_robot_golden_demo(tmp_path, robot_root):
    """robot_demo: trained on the tree (dropout 0.1, whose bits JAX cannot
    share), then the golden demo on the just-trained members, through the
    command."""
    out = tmp_path / "report.json"
    with pytest.raises(SystemExit) as e:
        main(["acceptance", "robot_demo", "--data-root", str(robot_root),
              "--checkpoint-dir", str(tmp_path / "ck"), "--train-from-scratch",
              "--epochs", "1", "--demo-clips", "clip1[0]", "--device", "cpu",
              "-o", str(out),
              *(f"--set=model.{k}={json.dumps(v)}".replace(" ", "")
                for k, v in ROBOT_OV["model"].items()),
              "--set=train.batch_size=4", "--set=train.n_folds=2"])
    assert e.value.code == 0
    report = json.loads(out.read_text())
    assert report["ok"] and len(report["trained"]["fold_best_valid_losses"]) == 2
    demo = report["golden_demo"]
    assert set(demo["clips"]) == {"clip1[0]"}
    assert demo["reference_expected"] == GOLDEN_DEMO_EXPECTED
    for probs in demo["clips"].values():
        assert set(probs) == set(configs.get("robot_demo").emotion_names)
        assert all(0.0 <= p <= 1.0 for p in probs.values())


def test_acceptance_train_from_scratch_rejects_torch_ckpts(tmp_path):
    for run in (run_acceptance, jacc.run_acceptance):
        with pytest.raises(ValueError, match="train-from-scratch"):
            run("mosei_trans", str(tmp_path), checkpoint_dir=str(tmp_path / "ck"),
                torch_ckpts=["x.pt"], train_from_scratch=True)
    assert acceptance.REFERENCE_FOLD_LOSSES == jacc.REFERENCE_FOLD_LOSSES
    assert acceptance.GOLDEN_DEMO_EXPECTED == jacc.GOLDEN_DEMO_EXPECTED

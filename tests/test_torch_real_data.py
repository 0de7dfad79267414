"""PyTorch port, the real corpora: the port's corpus readers against the
JAX package's on miniature on-disk trees (tests/corpus_fixtures.py) at tiny
widths, on the CPU.

  * `load_real_data` gives the same samples, bit for bit, key for key and in
    the same order, for all five families: the MOSEI `.csd` layouts, pair
    units and crop groups, the realformer's paragraph windows, the Ren-MME
    missing-video fallback, the Ren-CECps document range and robot's
    multi-resolution video and `name_idx`;
  * robot's per-epoch text substitution (`epoch_materialize`, a
    `Batcher(resample=)` epoch) and the Batcher's row-by-row fallback for
    ragged lists give JAX's batches;
  * `validate_tree`, `standard_test_fold` and `check-data` report what JAX's
    do, on good trees and on trees with a file or directory missing (the
    port's own module named in one message aside);
  * `run_experiment(data_root=...)` for `mosei_trans` (pair units carved
    whole, crop averaging) and `robot_demo` (2 epochs of resampled texts)
    against JAX's `run_experiment(synthetic_data=False, vmap_folds=False)`
    from the same start weights: member losses within 2e-4
    (tests/test_interop.py:20), and for `mosei_trans` the ensemble logits
    (normalised) within 2e-4 and the same report;
  * `run_predict(split="all")` numbers the crop groups as JAX does, and
    `cli train|predict|check-data --data-root` run on the CPU.

Only the MOSEI cases read `.csd` files; they skip where h5py does not
import, and the other families' cases run all the same.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu import pipelines as jpipelines  # noqa: E402
from multimodal_emotion_processing_tpu.data import loader as jloader  # noqa: E402
from multimodal_emotion_processing_tpu.data import mosei_folds as jfolds  # noqa: E402
from multimodal_emotion_processing_tpu.data import validate as jvalidate  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs, pipelines  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader, mosei_folds, validate  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.sources import CsdSource  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402

from corpus_fixtures import (  # noqa: E402
    build_mosei_tree, build_ren_mme_tree, build_rencecps_tree,
    build_robot_tree)
from test_torch_pipelines import _rel, _same_start  # noqa: E402

F32_TOL = 2e-4
MOSEI_DIMS = dict(l_dim=12, v_dim=7, a_dim=9)
OVERRIDES = {
    "mosei_trans": {"model": {**MOSEI_DIMS, "l_len": 8, "v_len": 10,
                              "a_len": 12, "dim": 12, "n_heads": 2},
                    "train": {"batch_size": 4, "n_folds": 2,
                              "fold_size": None}},
    "mosei_realformer": {"model": {**MOSEI_DIMS, "l_len": 10, "v_len": 10,
                                   "a_len": 10, "dim": 12, "n_heads": 2,
                                   "p_len": 3},
                         "train": {"batch_size": 4, "n_folds": 2}},
    # rencecps reads 16-d tokens and flattens them to 3 x 16
    "rencecps": {"model": {"l_dim": 48, "dim": 48},
                 "train": {"batch_size": 64, "n_folds": 2, "fold_size": None}},
    "ren_mme": {"model": {"l_dim": 8, "v_dim": 6, "a_dim": 5, "l_len": 6,
                          "v_len": 7, "a_len": 9, "dim": 16, "n_heads": 2},
                "train": {"batch_size": 4, "n_folds": 2, "fold_size": None}},
    "robot_demo": {"model": {"l_dim": 16, "a_dim": 5, "l_len": 4, "v_len": 9,
                             "a_len": 9, "dim": 12, "n_heads": 2,
                             "v_dims_multires": [3, 4, 5], "dropout": 0.0},
                   "train": {"batch_size": 4, "n_folds": 2,
                             "fold_size": None}},
}
EPOCHS = {"mosei_trans": 1, "robot_demo": 2}
IMPL = {"mosei_trans": "pallas_fused", "robot_demo": "pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny models run op by op: with several test processes on one
    host, PyTorch's default of one intra-op thread per core oversubscribes
    it and the tests slow tenfold.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(name):
    return configs.with_overrides(configs.get(name), OVERRIDES[name])


def _jexp(name):
    return jconfigs.with_overrides(jconfigs.get(name), OVERRIDES[name])


@pytest.fixture(scope="module")
def ren_trees(tmp_path_factory):
    """Ren-MME with video 1_1_3 missing, and the shared Ren-CECps tree (the
    full cet_1..cet_1487 range) with the robot's clips beside it."""
    root = tmp_path_factory.mktemp("ren_corpora")
    ren_mme = root / "ren_mme"
    build_ren_mme_tree(ren_mme, _exp("ren_mme").model, seed=3,
                       missing_video="1_1_3")
    ren = root / "ren"
    build_rencecps_tree(ren, tok_dim=16, seed=2)
    build_robot_tree(ren, _exp("robot_demo").model, n_clips=10, seed=4)
    return {"ren_mme": ren_mme, "rencecps": ren, "robot_demo": ren}


@pytest.fixture(scope="module")
def mosei_tree(tmp_path_factory):
    """The MOSEI tree, read by mosei_trans and mosei_realformer: its `.csd`
    files need h5py, so only the tests that read it skip without it."""
    pytest.importorskip("h5py")
    mosei = tmp_path_factory.mktemp("mosei_corpus") / "mosei"
    build_mosei_tree(mosei, _exp("mosei_trans").model, n_train_videos=5,
                     n_test_videos=2, seed=0)
    return mosei


@pytest.fixture
def trees(request, ren_trees):
    """Family name -> its tree; the MOSEI tree is built (or the test
    skipped) only when a MOSEI family is looked up."""

    class Trees(dict):
        def __missing__(self, name):
            if not name.startswith("mosei"):
                raise KeyError(name)
            return request.getfixturevalue("mosei_tree")

    return Trees(ren_trees)


def _assert_same(got, want, where="samples"):
    """The same structure, keys in the same order, and every array of the
    same dtype, shape and bytes."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        assert g.tobytes() == w.tobytes(), where


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_load_real_data_matches_jax(trees, name):
    train, test, ctx = pipelines.load_real_data(_exp(name), str(trees[name]))
    jtrain, jtest, jctx = jpipelines.load_real_data(_jexp(name),
                                                    str(trees[name]))
    _assert_same(train, jtrain, "train")
    _assert_same(test, jtest, "test")
    assert len(train) > 0
    if name == "mosei_trans":
        # pair units of one or two crops; test crops grouped by pair
        assert {len(u) for u in train} == {1, 2}
        assert len({int(s["group"]) for s in test}) < len(test)
    if name == "mosei_realformer":
        assert all(s["clip_mask"][0] == 1.0 for s in train + test)
    if name == "ren_mme":
        # 1_1_3 has no video: its sample carries 1_1_2's
        m = _exp(name).model
        names = [f"{e}_{d}_{s}" for e in (1, 2) for d in (1, 2)
                 for s in range(1, 5)]
        feat = np.load(trees[name] / "video_feat" / "1_1_2.npy")[:m.v_len]
        np.testing.assert_array_equal(
            train[names.index("1_1_3")]["v"][1][:len(feat)], feat)
    if name == "rencecps":
        assert len(train) > 1000 and len(test) > 250
    if name == "robot_demo":
        assert test == [] and jtest == []
        assert ctx["names"] == jctx["names"]
        assert ctx["table"] == jctx["table"]
        assert [int(s["name_idx"]) for s in train] == list(range(len(train)))
        slots = [tuple(bool(s[k].any()) for k in ("v256", "v512", "v1024"))
                 for s in train]
        assert {sum(x) for x in slots} == {0, 1}  # one slot, or an empty pickle
    else:
        assert ctx is None and jctx is None


def test_robot_epoch_resampling_matches_jax(trees):
    exp, jexp = _exp("robot_demo"), _jexp("robot_demo")
    root = str(trees["robot_demo"])
    _, _, ctx = pipelines.load_real_data(exp, root)
    _, _, jctx = jpipelines.load_real_data(jexp, root)
    names = ctx["names"][::2]
    texts = []
    for epoch in range(3):
        got = ctx["assembler"].epoch_materialize(names, ctx["table"], epoch,
                                                 seed=7)
        want = jctx["assembler"].epoch_materialize(names, jctx["table"],
                                                   epoch, seed=7)
        _assert_same(got, want, f"epoch {epoch}")
        texts.append(np.stack([s["l"] for s in got]))
    assert not np.array_equal(texts[0], texts[1])  # the texts move

    def resample(asm, table):
        return lambda e: asm.epoch_materialize(names, table, e, seed=3)

    first = ctx["assembler"].materialize(names)
    ours = loader.Batcher(first, 2, seed=1,
                          resample=resample(ctx["assembler"], ctx["table"]))
    theirs = jloader.Batcher(first, 2, seed=1,
                             resample=resample(jctx["assembler"],
                                               jctx["table"]))
    for epoch in range(2):
        _assert_same(list(ours()), list(theirs()), f"batches {epoch}")


@pytest.mark.parametrize("duplicate", [False, True])
def test_batcher_row_fallback_matches_jax(duplicate):
    """Samples whose `x` does not stack ((1, 3) and (3,)): JAX's Batcher
    gathers them row by row at the shape of each batch's first row, and so
    does the port's; an extra key in a later sample is left out."""
    rng = np.random.default_rng(0)
    samples = [{"x": rng.standard_normal((1, 3) if i % 3 == 0 else 3)
                .astype(np.float32),
                "label": np.asarray([i % 2, 1], np.int32)}
               for i in range(7)]
    samples[3]["extra"] = np.zeros(2, np.float32)
    ours = loader.Batcher(samples, 3, duplicate=duplicate, seed=5)
    theirs = jloader.Batcher(samples, 3, duplicate=duplicate, seed=5)
    for epoch in range(2):
        got, want = list(ours()), list(theirs())
        _assert_same(got, want, f"epoch {epoch}")
    assert ours._stacked is None and ours.steps_per_epoch() == 3


def _without(tmp_path, src, missing):
    """A view of tree `src` with `missing` (a file or directory name)
    left out: every other entry linked."""
    dst = tmp_path / "broken"
    dst.mkdir()
    for entry in os.listdir(src):
        if entry != missing:
            os.symlink(os.path.join(src, entry), dst / entry)
    return dst


def _normalise(report):
    """The one message that names the package's own module."""
    return json.loads(json.dumps(report).replace(
        mosei_folds.EXTRACT_COMMAND,
        "python -m multimodal_emotion_processing_tpu.data.mosei_folds"))


CHECKS = [("mosei_trans", None), ("mosei_realformer", None),
          ("rencecps", None), ("ren_mme", None), ("robot_demo", None),
          ("mosei_trans", "COAVAREP.csd"),
          ("mosei_trans", "standard_test_fold.txt"),
          ("mosei_realformer", "All Labels.csd"),
          ("rencecps", "1487_xml_doc_segmented_utf8"),
          ("ren_mme", "data"), ("robot_demo", "WAV_feature"),
          ("robot_demo", "labels.txt")]


@pytest.mark.parametrize("name,missing", CHECKS,
                         ids=[f"{n}-{m}" for n, m in CHECKS])
def test_validate_tree_matches_jax(trees, tmp_path, capsys, name, missing):
    root = str(trees[name] if missing is None
               else _without(tmp_path, trees[name], missing))
    got = validate.validate_tree(name, root)
    assert _normalise(got) == jvalidate.validate_tree(name, root)
    assert got["ok"] == (missing is None)
    if missing is not None:
        assert any(missing in p or missing.split(".")[0] in p
                   for p in got["problems"]), got["problems"]
    capsys.readouterr()
    if got["ok"]:
        assert main(["check-data", name, "--data-root", root]) == got
    else:
        with pytest.raises(SystemExit) as e:
            main(["check-data", name, "--data-root", root])
        assert e.value.code == 1
    assert json.loads(capsys.readouterr().out) == got


def test_validate_tree_without_a_root_or_family(tmp_path):
    for name, root in (("ren_mme", str(tmp_path / "nowhere")),
                       ("mosei_trans_s256", str(tmp_path))):
        got = validate.validate_tree(name, root)
        assert _normalise(got) == jvalidate.validate_tree(name, root)
        assert not got["ok"]


def test_standard_test_fold_matches_jax(trees, tmp_path):
    root = str(trees["mosei_trans"])
    assert mosei_folds.standard_test_fold(root) == \
        jfolds.standard_test_fold(root) == {"te0", "te1"}
    assert mosei_folds.standard_test_fold(root, explicit=["a"]) == {"a"}
    for where in (str(tmp_path), None):
        with pytest.raises(FileNotFoundError) as got:
            mosei_folds.standard_test_fold(where)
        with pytest.raises(FileNotFoundError) as want:
            jfolds.standard_test_fold(where)
        assert str(got.value).replace(
            mosei_folds.EXTRACT_COMMAND,
            "python -m multimodal_emotion_processing_tpu.data.mosei_folds"
        ) == str(want.value)
    with pytest.raises(ImportError, match="mmsdk"):
        mosei_folds.extract_fold_file(str(tmp_path))


def test_csd_source_layouts(tmp_path):
    """The layouts CsdSource accepts: a top-level "data" group, a sequence
    group with "data" beside "metadata", and bare datasets; a file with
    only "metadata" is refused."""
    h5py = pytest.importorskip("h5py")

    feats = np.arange(6, dtype=np.float64).reshape(3, 2)
    path = tmp_path / "x.csd"
    for layout in ("data", "seq", "bare"):
        with h5py.File(path, "w") as h:
            h.create_group("metadata")
            if layout == "data":
                h.create_group("data/s[0]").create_dataset("features",
                                                           data=feats)
            elif layout == "seq":
                h.create_group("seq/data/s[0]").create_dataset("features",
                                                               data=feats)
            else:
                h.create_group("seq").create_dataset("s[0]", data=feats)
        with CsdSource(str(path)) as src:
            assert "s[0]" in src and list(src.names()) == ["s[0]"]
            got = src.get("s[0]")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, feats)
    with h5py.File(path, "w") as h:
        h.create_group("metadata")
    with pytest.raises(ValueError, match="only 'metadata'"):
        CsdSource(str(path))


@pytest.mark.parametrize("name,part,extra", [("mosei_trans", 1, "group"),
                                              ("robot_demo", 0, "name_idx")])
def test_heads_ignore_the_extra_keys(trees, name, part, extra):
    """`group` (mosei_trans test crops) and `name_idx` (robot clips) reach
    the model with the batch: the logits are those of the batch without
    them."""
    exp = _exp(name)
    samples = pipelines.load_real_data(exp, str(trees[name]))[part]
    batch = next(iter(loader.Batcher(samples, 4, shuffle=False)()))
    assert extra in batch
    model = build_model(exp, device="cpu", seed=0).eval()
    with torch.no_grad():
        full = model(loader.to_device(batch, "cpu"))
        bare = model(loader.to_device(
            {k: v for k, v in batch.items() if k != extra}, "cpu"))
    assert torch.equal(full, bare)


@pytest.mark.parametrize("name", list(EPOCHS))
def test_run_experiment_on_a_tree_matches_jax(trees, tmp_path, monkeypatch,
                                              name):
    _same_start(monkeypatch)
    captured = {}
    collapse = jpipelines._collapse_test_outputs

    def capture(logits, samples):
        captured["logits"], captured["labels"] = collapse(logits, samples)
        return captured["logits"], captured["labels"]

    monkeypatch.setattr(jpipelines, "_collapse_test_outputs", capture)
    common = dict(synthetic_data=False, data_root=str(trees[name]),
                  epochs=EPOCHS[name], quiet=True, overrides=OVERRIDES[name])
    jres = jpipelines.run_experiment(name, vmap_folds=False, impl="xla",
                                     checkpoint_dir=str(tmp_path / "jax"),
                                     **common)
    res = pipelines.run_experiment(name, impl=IMPL[name], device="cpu",
                                   checkpoint_dir=str(tmp_path / "port"),
                                   **common)
    assert len(res.fold_histories) == len(jres.fold_histories) == 2
    for hist, jhist in zip(res.fold_histories, jres.fold_histories):
        assert len(hist) == len(jhist) == EPOCHS[name]
        for h, jh in zip(hist, jhist):
            assert h.steps == jh.steps and h.samples == jh.samples
            assert _rel(h.train_loss, jh.train_loss) <= F32_TOL, (h, jh)
            assert _rel(h.valid_loss, jh.valid_loss) <= F32_TOL, (h, jh)
    for n in (f"{name}_1", f"{name}_2"):
        got, want = res.store.manifest[n], jres.store.manifest[n]
        assert got["epoch"] == want["epoch"]
        assert _rel(got["valid_loss"], want["valid_loss"]) <= F32_TOL
    meta = json.load(open(tmp_path / "port" / "run_meta.json"))
    assert meta["data"]["synthetic"] is False
    assert meta["data"]["data_root"] == str(trees[name])
    if name == "robot_demo":  # no held-out split: nothing is scored
        assert res.report is None and jres.report is None
        return
    # pair units: the folds differ in samples though they count pairs alike
    assert res.fold_histories[0][0].samples != res.fold_histories[1][0].samples
    assert res.logits.shape == captured["logits"].shape
    scale = max(1.0, float(np.abs(captured["logits"]).max()))
    np.testing.assert_allclose(res.logits / scale,
                               captured["logits"] / scale, rtol=0,
                               atol=F32_TOL)
    np.testing.assert_array_equal(res.labels, captured["labels"])
    assert res.report == jres.report


def test_run_predict_numbers_the_groups_as_jax(trees, monkeypatch):
    """split="all": the test split's crop groups above the train split's,
    the same ids as JAX's and none across the splits."""
    seen = {}

    def spy(module, key):
        collapse = module._collapse_test_outputs

        def wrapped(logits, samples):
            seen[key] = ([int(s["group"]) for s in samples]
                         if "group" in samples[0] else None)
            return collapse(logits, samples)

        monkeypatch.setattr(module, "_collapse_test_outputs", wrapped)

    spy(pipelines, "port")
    spy(jpipelines, "jax")
    root = str(trees["mosei_trans"])
    kw = dict(init_random=True, synthetic_data=False, data_root=root,
              split="all", overrides=OVERRIDES["mosei_trans"], quiet=True)
    table = pipelines.run_predict("mosei_trans", device="cpu", **kw)
    jtable = jpipelines.run_predict("mosei_trans", **kw)
    assert seen["port"] == seen["jax"]
    train, test, _ = pipelines.load_real_data(_exp("mosei_trans"), root)
    n_train = sum(len(u) for u in train)
    assert set(seen["port"][:n_train]).isdisjoint(seen["port"][n_train:])
    assert table["rows"] == jtable["rows"] == len(set(seen["port"]))


def test_run_predict_without_a_test_split_takes_all_samples(trees):
    """A robot corpus has no held-out split: split "test" falls back to all
    its clips."""
    robot = pipelines.run_predict(
        "robot_demo", device="cpu", init_random=True, synthetic_data=False,
        data_root=str(trees["robot_demo"]),
        overrides=OVERRIDES["robot_demo"], quiet=True)
    assert robot["rows"] == 10


def test_cli_train_and_predict_on_a_tree(trees, tmp_path, capsys):
    """`train --data-root` prints each member epoch and the report;
    `predict --data-root` from its store gives the run's eval logits."""
    root = str(trees["mosei_trans"])
    ck = str(tmp_path / "ck")
    sets = [f"--set=model.{k}={json.dumps(v)}"
            for k, v in OVERRIDES["mosei_trans"]["model"].items()]
    sets += ["--set=train.batch_size=4", "--set=train.n_folds=2",
             "--set=train.fold_size=null"]
    res = main(["train", "mosei_trans", "--data-root", root, "--device",
                "cpu", "--epochs", "1", "--checkpoint-dir", ck, "--quiet",
                "--impl", "pallas_fused", *sets])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert sum("epoch" in x for x in lines) == 2
    assert lines[-1] == {"report": res.report}
    out = str(tmp_path / "pred.npz")
    main(["predict", "mosei_trans", "--data-root", root, "--checkpoint-dir",
          ck, "--device", "cpu", "-o", out, "--impl", "pallas_fused",
          "--quiet", *sets])
    summary = json.loads(capsys.readouterr().out)
    np.testing.assert_array_equal(np.load(out)["logits"], res.logits)
    assert summary["rows"] == res.logits.shape[0] and summary["members"] == 2


def test_real_data_needs_a_root():
    with pytest.raises(ValueError, match="data_root required"):
        pipelines.run_experiment("ren_mme", synthetic_data=False,
                                 device="cpu")
    with pytest.raises(ValueError, match="data_root required"):
        pipelines.run_predict("ren_mme", synthetic_data=False,
                              init_random=True, device="cpu")


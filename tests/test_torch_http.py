"""PyTorch port, the HTTP front end (`serve.http_api.HttpFrontend`) over the
port's `BatchingServer` on an ephemeral port: binary responses bit-equal
and JSON responses float32-exact to in-process `BatchingServer.predict`,
both within 2e-4 (tests/test_interop.py:20) of the JAX package's
`BatchingServer` on the same weights (carried over by `from_jax_params`),
concurrent clients on both wires, `/spec` equal to the JAX front end's for
the same spec, `/healthz`, 400 for a wrong shape or body, 404 for an
unknown path, and `cli serve --http-port`.  Tiny `mosei_trans` on the
CPU."""

import dataclasses
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.serve import (  # noqa: E402
    BatchingServer as JBatchingServer, HttpFrontend as JHttpFrontend)
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import BatchingServer, HttpFrontend  # noqa: E402

F32_TOL = 2e-4
TINY = dict(l_len=4, v_len=9, a_len=20, dim=12, n_heads=2, l_dim=7, v_dim=3,
            a_dim=5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny models run op by op: with several test processes on one
    host, PyTorch's default of one intra-op thread per core oversubscribes
    it and the tests slow tenfold.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    exp = configs.get("mosei_trans")
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, **TINY))
    jexp = dataclasses.replace(
        jconfigs.get("mosei_trans"),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)))
    jmodel = jbuild(jexp)
    params = [jmodel.init(jax.random.PRNGKey(i)) for i in range(3)]
    members = []
    for p in params:
        m = build_model(exp, device="cpu", seed=0)
        m.load_state_dict(from_jax_params(jax.device_get(p), exp.model))
        members.append(m)
    samples = synthetic_dataset(exp.name, exp.model, 6, seed=11)
    spec = {k: v.shape for k, v in samples[0].items() if k != "label"}
    names = exp.emotion_names[: len(exp.thresholds)]
    with BatchingServer(members, exp.thresholds, max_delay_ms=1.0) as srv:
        srv.warmup(samples[0])
        with HttpFrontend(srv, spec, names, port=0) as fe:
            yield dict(exp=exp, jmodel=jmodel, params=params, srv=srv, fe=fe,
                       samples=samples, spec=spec, names=names)


def _call(fe, path, body=None, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{fe.port}{path}",
                                 data=body, method="POST" if body is not None
                                 else "GET", headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _json_body(sample, spec):
    return json.dumps({k: np.asarray(sample[k]).tolist() for k in spec}).encode()


def _binary_body(sample, fe):
    return b"".join(np.asarray(sample[k], "<f4").tobytes()
                    for k in fe.binary_order())


def test_binary_bit_equal_and_json_float32_exact(served):
    fe, srv, spec = served["fe"], served["srv"], served["spec"]
    for s in served["samples"][:3]:
        logits, probs = srv.predict(s)
        code, got = _call(fe, "/predict", _binary_body(s, fe),
                          "application/octet-stream")
        assert code == 200
        np.testing.assert_array_equal(np.asarray(got["logits"], np.float32),
                                      logits)
        np.testing.assert_array_equal(np.asarray(got["probs"], np.float32),
                                      probs)
        code, js = _call(fe, "/predict", _json_body(s, spec))
        assert code == 200
        # JSON carries each float32 as the double of the same value
        assert js["logits"] == logits.tolist() and js["probs"] == probs.tolist()
        assert js["emotions"] == {n: float(p) for n, p in
                                  zip(served["names"], probs)}


def test_http_matches_jax_batching_server(served):
    fe, exp = served["fe"], served["exp"]
    with JBatchingServer(served["jmodel"], served["params"],
                         offsets=exp.thresholds) as jsrv:
        for s in served["samples"][:3]:
            jlogits, jprobs = jsrv.predict(s)
            _, got = _call(fe, "/predict", _binary_body(s, fe),
                           "application/octet-stream")
            scale = max(1.0, float(np.abs(jlogits).max()))
            assert np.abs(np.asarray(got["logits"]) - jlogits).max() <= F32_TOL * scale
            assert np.abs(np.asarray(got["probs"]) - jprobs).max() <= F32_TOL


def test_concurrent_clients_on_both_wires(served):
    fe, srv, spec = served["fe"], served["srv"], served["spec"]
    samples = served["samples"] * 3
    refs = [srv.predict(s) for s in samples]

    def one(i):
        s = samples[i]
        if i % 2:
            return _call(fe, "/predict", _binary_body(s, fe),
                         "application/octet-stream")
        return _call(fe, "/predict", _json_body(s, spec))

    with ThreadPoolExecutor(16) as pool:
        out = list(pool.map(one, range(len(samples))))
    for (code, got), (logits, probs) in zip(out, refs):
        assert code == 200
        # a request's result does not depend on its batch but for the
        # CPU's float rounding of another batch size
        np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["probs"], probs, rtol=0, atol=1e-6)


def test_spec_and_healthz_match_jax(served):
    fe, exp = served["fe"], served["exp"]
    with JBatchingServer(served["jmodel"], served["params"],
                         offsets=exp.thresholds) as jsrv:
        with JHttpFrontend(jsrv, served["spec"], served["names"],
                           port=0) as jfe:
            assert _call(fe, "/spec") == _call(jfe, "/spec")
    code, spec = _call(fe, "/spec")
    assert code == 200 and spec["binary_order"] == sorted(served["spec"])
    assert spec["binary_bytes"] == len(_binary_body(served["samples"][0], fe))
    code, health = _call(fe, "/healthz")
    assert code == 200 and health["status"] == "ok" and health["members"] == 3
    assert health["stats"]["requests"] >= 1


def test_bad_requests(served):
    fe, spec, s = served["fe"], served["spec"], served["samples"][0]
    bad = {k: np.asarray(s[k]).tolist() for k in spec}
    bad["l"] = bad["l"][:-1]
    code, err = _call(fe, "/predict", json.dumps(bad).encode())
    assert code == 400 and "expected" in err["error"]
    code, err = _call(fe, "/predict", _binary_body(s, fe)[:-4],
                      "application/octet-stream")
    assert code == 400 and "bytes" in err["error"]
    code, err = _call(fe, "/predict", b"{not json")
    assert code == 400
    code, _ = _call(fe, "/predict", json.dumps({"l": [1.0]}).encode())
    assert code == 400
    assert _call(fe, "/nope")[0] == 404
    assert _call(fe, "/nope", b"{}")[0] == 404


def test_cli_serve_http(monkeypatch, capsys):
    """`cli serve --http-port 0` opens the front end over the captured
    buckets; its blocking serve_forever is replaced by serving on a
    thread for two requests, then a return."""
    seen = {}

    def once(self):
        self.start()
        seen["spec"] = _call(self, "/spec")
        seen["health"] = _call(self, "/healthz")

    monkeypatch.setattr(HttpFrontend, "serve_forever", once)
    fe = main(["serve", "mosei_trans", "--device", "cpu", "--http-port", "0"]
              + [f"--set=model.{k}={v}" for k, v in TINY.items()])
    assert seen["spec"][0] == 200 and seen["health"][1]["members"] == 4
    assert "http://127.0.0.1:" in capsys.readouterr().err
    with pytest.raises(OSError):   # closed after serving
        urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/healthz",
                               timeout=5)

"""What the port's whole-run driver tests share (test_torch_device_epochs,
test_torch_accum, test_torch_vmap_kfold, test_torch_sweep): tiny configs
equal in both frameworks, JAX's shuffle injected into the port's one
shuffle function, and both frameworks started from the same weights."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import device_epochs, engine  # noqa: E402

F32_TOL = 2e-4      # tests/test_interop.py:20
EPOCH_TOL = 1e-3    # epoch losses
TINY = dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2, l_dim=5, v_dim=4,
            a_dim=3)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These tiny models run op by op: with several test processes on one
    host, PyTorch's default of one intra-op thread per core oversubscribes
    it and the tests slow tenfold.  One thread for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exps(name, model=None, **train):
    """(port ExperimentConfig, JAX ExperimentConfig) of `name` with the same
    model and train overrides; rencecps at dim 16 unless `model` says."""
    if model is None:
        model = {"dim": 16} if name == "rencecps" else dict(TINY)
    out = []
    for mod in (configs, jconfigs):
        exp = mod.get(name)
        out.append(dataclasses.replace(
            exp, model=dataclasses.replace(exp.model, **model),
            train=dataclasses.replace(exp.train, **train)))
    return tuple(out)


def flat(samples):
    return [s for u in samples for s in (u if isinstance(u, list) else [u])]


def jax_permutation(key_seed, epoch, n, device, members=None):
    """JAX's device shuffle for the same key: permutation(fold_in(
    PRNGKey(key_seed), epoch), n), or with `members` one row per key of
    split(that key, members), as JAX's drivers draw them."""
    key = jax.random.fold_in(jax.random.PRNGKey(key_seed), epoch)
    if members is None:
        perm = jax.random.permutation(key, n)
    else:
        perm = jax.vmap(lambda k: jax.random.permutation(k, n))(
            jax.random.split(key, members))
    return torch.from_numpy(np.asarray(perm).astype(np.int64)).to(device)


@pytest.fixture
def jax_shuffle(monkeypatch):
    """The port's drivers draw JAX's permutations."""
    monkeypatch.setattr(device_epochs, "epoch_permutation", jax_permutation)
    from multimodal_emotion_processing_tpu_torch.train import sweep, vmap_kfold

    monkeypatch.setattr(vmap_kfold, "epoch_permutation", jax_permutation)
    monkeypatch.setattr(sweep, "epoch_permutation", jax_permutation)


class Spread:
    """A JAX model whose init moves the LayerNorm biases by 0.1·N(0, 1) and
    draws every gate a, b, c from U(0.25, 1) (at init the biases tie
    across blocks and the max pool's routing would rest on the last ulp;
    gates at 0 hide the attention), with jax.random from the init key, so
    that it also traces under JAX's vmapped init."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, key):
        params = self._model.init(key)
        leaves = jax.tree_util.tree_leaves_with_path(params)
        keys = dict(zip((tuple(p) for p, _ in leaves),
                        jax.random.split(jax.random.fold_in(key, 1000),
                                         len(leaves))))

        def move(path, x):
            names = [str(getattr(k, "key", k)) for k in path]
            k = keys[tuple(path)]
            if names[-1] in ("a", "b", "c"):
                return jax.random.uniform(k, x.shape, x.dtype, 0.25, 1.0)
            if names[-1] == "bias" and any("norm" in n for n in names):
                return x + 0.1 * jax.random.normal(k, x.shape, x.dtype)
            return x

        return jax.tree_util.tree_map_with_path(move, params)


def jax_model(jexp, spread=True):
    model = jbuild(jexp)
    return Spread(model) if spread else model


def jax_init_params(jmodel, seed):
    """JAX's init of a member of `seed` (engine.init_state's and the vmapped
    drivers' split of PRNGKey(seed))."""
    return jmodel.init(jax.random.split(jax.random.PRNGKey(seed))[0])


@pytest.fixture
def same_start(monkeypatch):
    """same_start(jmodel): the port's init_state of seed s loads JAX's init
    of s through `jmodel`; both frameworks then start each member from the
    same weights."""
    init = engine.init_state

    def use(jmodel):
        def port_init(cfg, tcfg, seed, **kw):
            st = init(cfg, tcfg, seed, **kw)
            params = jax.device_get(jax_init_params(jmodel, seed))
            st.model.load_state_dict(from_jax_params(
                params, getattr(cfg, "model", cfg)))
            return st

        monkeypatch.setattr(engine, "init_state", port_init)

    return use


def port_params(jparams, cfg):
    return from_jax_params(jax.device_get(jparams), getattr(cfg, "model", cfg))


def assert_state_dicts_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_params_close(port_sd, jparams, cfg, tol=F32_TOL):
    want = port_params(jparams, cfg)
    for k, v in port_sd.items():
        w = want[k]
        scale = max(1.0, float(w.abs().max()))
        assert float((v - w).abs().max()) / scale <= tol, k


def rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def jnp_batch(batch):
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}

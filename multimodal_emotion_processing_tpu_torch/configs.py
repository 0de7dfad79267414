"""Typed configurations for the PyTorch port.

The port keeps its own copy of the configuration dataclasses and of the
registered families, field for field the same as the JAX package's, so a
config name means the same model on either side: the five reference
families (`mosei_trans` and its scale presets, `mosei_realformer`,
`rencecps`, `ren_mme` and `robot_demo`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of one cross-modal grid encoder + head."""

    # modality feature dims / fixed sequence lengths
    l_dim: int = 300
    v_dim: int = 35
    a_dim: int = 74
    l_len: int = 20
    v_len: int = 100
    a_len: int = 200
    # encoder
    dim: int = 96
    n_heads: int = 6
    n_layers: int = 1
    ffn: int = 1
    dropout: float = 0.0
    # block variant: 'minus' (cmu-mosei/run.py:217-262) or 'realformer'
    block: str = "minus"
    use_position_embedding: bool = False
    # unify projection: 'linear' (bias-free Linear), 'linear_ln', 'conv',
    # 'conv_multires'
    unify: str = "linear"
    n_emotions: int = 7
    # head on top of the grid(s): 'concat_trans', 'state_transfer', ...
    head: str = "concat_trans"
    p_len: int = 6
    # attention implementation the CLI uses when none is passed:
    # 'xla' (the plain einsum path), 'flash' (the online-softmax kernel,
    # terminal blocks only; other blocks take the plain path), 'pallas'
    # (the score-materializing kernels, every block, forward and backward)
    # or 'pallas_fused' (the whole minus block in one kernel while dropout
    # is inactive, with the pallas backward kernels; other blocks take
    # 'pallas')
    attn_impl: str = "xla"
    v_dims_multires: Tuple[int, int, int] = (256, 512, 1024)
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization & schedule — reference defaults per script."""

    batch_size: int = 64
    lr: float = 1e-3
    epochs: int = 999
    grad_clip: float = 1.0
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    plateau_factor: float = 0.1
    plateau_patience: int = 4
    early_stop: int = 9
    save_guard: Optional[float] = 0.009
    n_folds: int = 4
    fold_size: Optional[int] = None
    rdrop_kl: bool = False
    clip_mask_loss: bool = False
    seed: int = 0
    # 'float32' or 'bfloat16': the dtype the forward computes in
    compute_dtype: str = "float32"
    fused_optimizer: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: ModelConfig
    train: TrainConfig
    # per-emotion decision thresholds (serving: calibrated sigmoid offsets)
    thresholds: Tuple[float, ...] = ()
    emotion_names: Tuple[str, ...] = ()
    emotion_index: Tuple[int, ...] = ()


def mosei_trans() -> ExperimentConfig:
    """CMU-MOSEI sentence-pair emotion-transition model (cmu-mosei/run.py)."""
    return ExperimentConfig(
        name="mosei_trans",
        model=ModelConfig(
            l_dim=300, v_dim=35, a_dim=74,
            l_len=20, v_len=100, a_len=200,
            dim=96, n_heads=6, n_layers=1, ffn=1, dropout=0.0,
            block="minus", use_position_embedding=False, unify="linear",
            n_emotions=7, head="concat_trans",
        ),
        train=TrainConfig(
            batch_size=64, lr=1e-3, epochs=999, grad_clip=1.0,
            optimizer="adamw", plateau_patience=4, early_stop=9,
            save_guard=0.009, n_folds=4, fold_size=4096,
        ),
        # cmu-mosei/run.py:481-486 — fixed per-emotion thresholds
        thresholds=(0.1, -0.3, -0.5, -0.3, -0.6, -0.5),
        emotion_names=("happ", "sadn", "ange", "disg", "surp", "fear"),
        emotion_index=(0, 1, 2, 3, 4, 5),
    )


def mosei_realformer() -> ExperimentConfig:
    """CMU-MOSEI RealFormer paragraph model (others/realformer.py)."""
    return ExperimentConfig(
        name="mosei_realformer",
        model=ModelConfig(
            l_dim=300, v_dim=35, a_dim=74,
            l_len=50, v_len=50, a_len=50,
            dim=96, n_heads=6, n_layers=2, ffn=2, dropout=0.0,
            block="realformer", use_position_embedding=True, unify="conv",
            n_emotions=6, head="state_transfer", p_len=6,
        ),
        train=TrainConfig(
            batch_size=64, lr=1e-3, epochs=99, grad_clip=1.0,
            optimizer="adam", plateau_patience=2, early_stop=4,
            save_guard=None, n_folds=5, clip_mask_loss=True,
        ),
        emotion_names=("happ", "sadn", "ange", "surp", "disg", "fear"),
        emotion_index=(0, 1, 2, 3, 4, 5),
    )


def rencecps() -> ExperimentConfig:
    """Ren-CECps Chinese-text 8-emotion classifier (rencecps/run.py)."""
    return ExperimentConfig(
        name="rencecps",
        model=ModelConfig(
            l_dim=768 * 3, v_dim=0, a_dim=0, l_len=2, v_len=0, a_len=0,
            dim=768 * 3, dropout=0.1,
            block="minus", unify="linear", n_emotions=9, head="concat_linear",
        ),
        train=TrainConfig(
            batch_size=64, lr=1e-3, epochs=99, grad_clip=1.0,
            optimizer="adamw", plateau_patience=6, early_stop=15,
            save_guard=0.009, n_folds=4, fold_size=6720,
        ),
        # rencecps/run.py:288-295
        thresholds=(-0.7, -0.8, -0.3, -0.2, -0.2, -0.8, -0.8, -0.9),
        emotion_names=("love", "anxi", "sorr", "joyy", "expe", "hate", "ange", "surp"),
        emotion_index=(0, 1, 2, 3, 4, 5, 6, 7),
    )


def ren_mme() -> ExperimentConfig:
    """Ren-MME TV-drama multimodal 9-emotion trainer (Ren-MME/run.py)."""
    return ExperimentConfig(
        name="ren_mme",
        model=ModelConfig(
            l_dim=768, v_dim=640, a_dim=205,
            l_len=40, v_len=76, a_len=275,
            dim=128, n_heads=8, n_layers=1, ffn=1, dropout=0.1,
            block="minus", use_position_embedding=False, unify="linear_ln",
            n_emotions=9, head="concat_trans",
        ),
        train=TrainConfig(
            batch_size=16, lr=1e-3, epochs=999, grad_clip=1.0,
            optimizer="adamw", plateau_patience=1, early_stop=3,
            save_guard=0.009, n_folds=4, fold_size=744, rdrop_kl=True,
        ),
        # Ren-MME/run.py:735-742
        thresholds=(-3.6, -1.2, -1.4, -3.4, -2.0, -1.4, -2.6, -3.8),
        emotion_names=("love", "anxi", "sorr", "joyy", "expe", "hate", "ange", "surp"),
        emotion_index=(0, 1, 2, 3, 4, 5, 6, 7),
    )


def robot_demo() -> ExperimentConfig:
    """Streaming single-sample inference demo (robot_demo.py)."""
    return ExperimentConfig(
        name="robot_demo",
        model=ModelConfig(
            l_dim=768, v_dim=0, a_dim=40,
            l_len=25, v_len=100, a_len=100,
            dim=192, n_heads=6, n_layers=2, ffn=2, dropout=0.1,
            block="realformer", use_position_embedding=True, unify="conv_multires",
            n_emotions=7, head="grid_only",
            v_dims_multires=(256, 512, 1024),
        ),
        train=TrainConfig(
            batch_size=64, lr=1e-3, epochs=99, grad_clip=1.0,
            optimizer="adamw", plateau_patience=3, early_stop=7,
            save_guard=None, n_folds=4,
        ),
        # robot_demo.py:609 — calibrated-sigmoid offsets (serving path)
        thresholds=(0.1, 0.1, -0.1, 0.0, 0.1, 0.0),
        emotion_names=("happ", "sadn", "ange", "disg", "surp", "fear"),
        emotion_index=(0, 1, 2, 3, 4, 5),
    )


# Scaled presets: the flagship architecture at larger encoder widths over the
# same raw modality features.  Every point keeps the head width
# dh = dim / n_heads = 128 and computes in bfloat16.
SCALE_POINTS = {
    "s256": dict(dim=256, n_heads=2, l_len=64, v_len=128, a_len=256,
                 batch_size=256),
    "s512": dict(dim=512, n_heads=4, l_len=128, v_len=256, a_len=512,
                 batch_size=64),
    "s1024": dict(dim=1024, n_heads=8, l_len=128, v_len=256, a_len=512,
                  batch_size=64),
}


def family(name: str) -> str:
    """'mosei_trans_s256' -> 'mosei_trans': scaled presets share the base
    config's samplers."""
    return re.sub(r"_s\d+$", "", name)


def _mosei_trans_scaled(point: str) -> ExperimentConfig:
    spec = SCALE_POINTS[point]
    base = mosei_trans()
    return dataclasses.replace(
        base,
        name=f"mosei_trans_{point}",
        model=dataclasses.replace(
            base.model, dim=spec["dim"], n_heads=spec["n_heads"],
            l_len=spec["l_len"], v_len=spec["v_len"], a_len=spec["a_len"],
            attn_impl="flash"),
        train=dataclasses.replace(
            base.train, batch_size=spec["batch_size"],
            compute_dtype="bfloat16", fused_optimizer=False))


REGISTRY = {
    "mosei_trans": mosei_trans,
    "mosei_realformer": mosei_realformer,
    "rencecps": rencecps,
    "ren_mme": ren_mme,
    "robot_demo": robot_demo,
    **{f"mosei_trans_{p}": (lambda p=p: _mosei_trans_scaled(p))
       for p in SCALE_POINTS},
}


def get(name: str) -> ExperimentConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown config {name!r}; choose from {sorted(REGISTRY)}")
    return REGISTRY[name]()


def with_overrides(exp: ExperimentConfig, overrides) -> ExperimentConfig:
    """Apply a {'model': {...}, 'train': {...}} override dict (the CLI's
    --set K=V pairs).  Unknown sections raise; list values become tuples
    where the field is a tuple."""
    if not overrides:
        return exp
    unknown = set(overrides) - {"model", "train"}
    if unknown:
        raise KeyError(
            f"unknown override section(s) {sorted(unknown)}; expected "
            "{'model': {...}, 'train': {...}} (the CLI's --set "
            "model.K=V / train.K=V form)")

    def coerce(current, fields):
        return {k: tuple(v) if isinstance(getattr(current, k, None), tuple)
                and isinstance(v, list) else v
                for k, v in fields.items()}

    return dataclasses.replace(
        exp,
        model=dataclasses.replace(
            exp.model, **coerce(exp.model, overrides.get("model", {}))),
        train=dataclasses.replace(
            exp.train, **coerce(exp.train, overrides.get("train", {}))))

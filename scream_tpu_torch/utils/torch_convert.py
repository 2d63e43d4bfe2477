"""Convert reference PyTorch checkpoints (``.pth``) into torch checkpoints of
the port (port of ``scream_tpu/utils/torch_convert.py``).

A user of the reference holds ``point-generator.pth`` / ``kitti-generator.pth``
/ ``dem-generator.pth`` / ``discriminator.pth`` (reference
``train_3d_match.py:30-31``, ``evaluate_3d_match.py:190``) and loads them
with ``net.load_state_dict``. This module maps those state_dicts onto the
port's modules, through the same nested tree the JAX package builds (this
module keeps its own copy of the JAX package's layout rules), then
:func:`~scream_tpu_torch.utils.convert.params_from_jax` /
:func:`~scream_tpu_torch.utils.convert.discriminator_from_jax`:

  * ``PointTransformer`` (reference ``models/pointnet.py:8-36``) ->
    :class:`scream_tpu_torch.models.PointTransformer`
  * ``DEMTransformer`` (``:103-133``) -> :class:`DEMTransformer`
  * ``NLayerDiscriminator`` (reference ``models/gan.py:15-62``) ->
    :class:`scream_tpu_torch.models.PatchDiscriminator`

Layout rules (to the tree; the port keeps flax's ``(in, out)`` kernels):
  * ``nn.Linear`` weight ``(out, in)``        -> ``kernel`` = W.T
  * ``nn.Conv1d``  weight ``(out, in, 1)``    -> Dense ``kernel`` = W[:, :, 0].T
    (the reference's kernel-size-1 Conv1d over points is a per-point Dense)
  * ``nn.Conv2d``  weight ``(out, in, kh, kw)`` -> Conv ``kernel`` =
    transpose to ``(kh, kw, in, out)``
  * ``nn.LayerNorm`` / ``nn.BatchNorm2d`` ``weight``/``bias`` -> ``scale``/``bias``;
    BatchNorm running stats -> ``batch_stats`` (``num_batches_tracked`` is
    not read: the port's BatchNorm, like flax's, keeps no step count).

Module-name map (reference -> tree):
  * ``stem.{i}``            -> ``trunk/stem_{i}`` (shared stem)
  * ``stem_dsm.{i}``        -> ``trunk/stem_src_{i}``; ``stem_dem.{i}`` -> ``trunk/stem_tgt_{i}``
  * ``cross.{2i}``          -> ``trunk/cross_self_{i}`` (plain MHAttention)
  * ``cross.{2i+1}.layer``  -> ``trunk/cross_attn_{i}`` (CrossAttention wrapper)
  * ``coor_mlp.{0,2,4}``    -> ``trunk/head_{0,1,out}``
  * MHAttention leaves: ``q/k/v_proj, merge`` -> same; ``mlp.0/2`` ->
    ``ffn_in/ffn_out``; ``norm1/norm2`` -> same.

The renderer holds no parameters and ``pe_func`` is parameter-free, so the
state_dicts above are covered completely.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

# The attention layers' head count is not in the weights: the reference's
# MHAttention default, the port's ModelConfig default.
NUM_HEADS = 8


def _np(t) -> np.ndarray:
    """torch tensor | ndarray -> float32 ndarray (host)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _linear(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _conv1d_as_dense(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{key}.weight"])  # (out, in, 1)
    if w.ndim != 3 or w.shape[-1] != 1:
        raise ValueError(f"{key}: expected kernel-size-1 Conv1d, got {w.shape}")
    out = {"kernel": w[:, :, 0].T}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _norm(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _attention_block(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Reference ``MHAttention`` under ``prefix`` -> AttentionBlock params
    (reference ``models/transformer.py:47-72``)."""
    return {
        "q_proj": _linear(sd, f"{prefix}.q_proj"),
        "k_proj": _linear(sd, f"{prefix}.k_proj"),
        "v_proj": _linear(sd, f"{prefix}.v_proj"),
        "merge": _linear(sd, f"{prefix}.merge"),
        "ffn_in": _linear(sd, f"{prefix}.mlp.0"),
        "ffn_out": _linear(sd, f"{prefix}.mlp.2"),
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
    }


def _trunk_common(sd: Mapping[str, Any], n_cross: int) -> Dict[str, Any]:
    trunk: Dict[str, Any] = {
        "embedding": _conv1d_as_dense(sd, "embedding"),
        "pre_norm": _norm(sd, "pre_norm"),
        "head_0": _conv1d_as_dense(sd, "coor_mlp.0"),
        "head_1": _conv1d_as_dense(sd, "coor_mlp.2"),
        "head_out": _conv1d_as_dense(sd, "coor_mlp.4"),
    }
    for i in range(n_cross):
        # Even cross entries are plain MHAttention (self), odd are
        # CrossAttention wrapping MHAttention at ``.layer`` (reference
        # ``models/pointnet.py:22-25,53-57``).
        trunk[f"cross_self_{i}"] = _attention_block(sd, f"cross.{2 * i}")
        trunk[f"cross_attn_{i}"] = _attention_block(sd, f"cross.{2 * i + 1}.layer")
    return trunk


def _infer_layer_count(sd: Mapping[str, Any], fmt: str) -> int:
    n = 0
    while f"{fmt % n}.q_proj.weight" in sd:
        n += 1
    return n


def _infer_cross_count(sd: Mapping[str, Any]) -> int:
    """Cross blocks come in (MHAttention, CrossAttention) pairs; the odd
    entries nest their weights under ``.layer`` (reference
    ``models/pointnet.py:22-25``)."""
    n = 0
    while (f"cross.{2 * n}.q_proj.weight" in sd
           and f"cross.{2 * n + 1}.layer.q_proj.weight" in sd):
        n += 1
    return n


def convert_point_transformer(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference ``PointTransformer.state_dict()`` -> the nested numpy tree
    of :class:`~scream_tpu_torch.models.PointTransformer` (the JAX
    package's ``params`` tree)."""
    n_self = _infer_layer_count(sd, "stem.%d")
    n_cross = _infer_cross_count(sd)
    if n_self == 0 or n_cross == 0:
        raise ValueError(
            "state_dict has no stem./cross. attention layers — not a "
            f"PointTransformer checkpoint? (keys: {sorted(sd)[:5]}...)")
    trunk = _trunk_common(sd, n_cross)
    for i in range(n_self):
        trunk[f"stem_{i}"] = _attention_block(sd, f"stem.{i}")
    return {"trunk": trunk}


def convert_dem_transformer(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference ``DEMTransformer.state_dict()`` -> the nested numpy tree of
    :class:`~scream_tpu_torch.models.DEMTransformer`."""
    n_self = _infer_layer_count(sd, "stem_dsm.%d")
    n_cross = _infer_cross_count(sd)
    if n_self == 0 or n_cross == 0:
        raise ValueError(
            "state_dict has no stem_dsm./cross. attention layers — not a "
            f"DEMTransformer checkpoint? (keys: {sorted(sd)[:5]}...)")
    trunk = _trunk_common(sd, n_cross)
    for i in range(n_self):
        trunk[f"stem_src_{i}"] = _attention_block(sd, f"stem_dsm.{i}")
        trunk[f"stem_tgt_{i}"] = _attention_block(sd, f"stem_dem.{i}")
    return {"trunk": trunk}


def convert_discriminator(sd: Mapping[str, Any], n_layers: int = 3
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference ``NLayerDiscriminator.state_dict()`` -> (params, batch_stats)
    trees of the PatchGAN.

    The reference builds a flat ``main`` Sequential (reference
    ``models/gan.py:39-62``): conv indices 0, 3n-1 (n=1..L-1), 3L-1, 3L+2;
    BatchNorms one index after their conv. The checkpoint may be a raw
    state_dict or wrapped by ``AdversarialLoss`` (keys prefixed
    ``discriminator.main.``, reference ``loss.py:19-24``).
    """
    if any(k.startswith("discriminator.") for k in sd):
        sd = {k[len("discriminator."):]: v for k, v in sd.items()
              if k.startswith("discriminator.")}

    def conv2d(idx: int) -> Dict[str, np.ndarray]:
        w = _np(sd[f"main.{idx}.weight"])  # (out, in, kh, kw)
        out = {"kernel": np.transpose(w, (2, 3, 1, 0))}
        if f"main.{idx}.bias" in sd:
            out["bias"] = _np(sd[f"main.{idx}.bias"])
        return out

    def bn(n: int):
        params[f"bn_{n}"] = _norm(sd, f"main.{3 * n}")
        stats[f"bn_{n}"] = {"mean": _np(sd[f"main.{3 * n}.running_mean"]),
                            "var": _np(sd[f"main.{3 * n}.running_var"])}

    params: Dict[str, Any] = {"conv_0": conv2d(0)}
    stats: Dict[str, Any] = {}
    for n in range(1, n_layers):
        params[f"conv_{n}"] = conv2d(3 * n - 1)
        bn(n)
    params[f"conv_{n_layers}"] = conv2d(3 * n_layers - 1)
    bn(n_layers)
    params["conv_out"] = conv2d(3 * n_layers + 2)
    return params, stats


_CONVERTERS = {
    "point": convert_point_transformer,
    "dem": convert_dem_transformer,
}


def convert_state_dict(sd: Mapping[str, Any], model: str = "point"):
    """``(tree, state_dict, sidecar)`` of a reference state_dict: the nested
    numpy tree (the JAX converter's), the port's ``state_dict`` and the
    ``model_config.json`` sidecar, the architecture read from the weights
    (``d_model`` and ``ffn_mult``, where it is not 4, from the first cross
    block's FFN, the layer counts from the keys, ``NUM_HEADS`` heads; the
    discriminator's constructor arguments)."""
    from scream_tpu_torch.utils.convert import discriminator_from_jax, params_from_jax

    if model == "disc":
        params, stats = convert_discriminator(sd)
        tree: Dict[str, Any] = {"params": params, "batch_stats": stats}
        k = params["conv_0"]["kernel"]
        sidecar = {"input_nc": int(k.shape[2]), "ndf": int(k.shape[3]), "n_layers": 3}
        return tree, discriminator_from_jax(tree), sidecar
    if model not in _CONVERTERS:
        raise ValueError(f"model must be point|dem|disc, got {model!r}")
    tree = _CONVERTERS[model](sd)
    d, hid = tree["trunk"]["cross_self_0"]["ffn_in"]["kernel"].shape
    sidecar: Dict[str, Any] = {
        "d_model": int(d), "num_heads": NUM_HEADS,
        "self_layers": _infer_layer_count(sd, "stem_dsm.%d" if model == "dem" else "stem.%d"),
        "cross_layers": _infer_cross_count(sd)}
    if hid != 4 * d:
        sidecar["ffn_mult"] = int(hid // d)
    if model == "dem":
        sidecar["separate_stems"] = True
    return tree, params_from_jax(tree), sidecar


def convert_torch_checkpoint(pth_path: str, out_dir: str, model: str = "point"):
    """Load a reference ``.pth`` and save it as a torch checkpoint directory
    of the port (``model.pt`` + ``model_config.json``, ``save_params``),
    after loading it strictly into the architecture its sidecar names.
    ``model``: "point" (point-generator.pth / kitti-generator.pth), "dem"
    (dem-generator.pth) or "disc" (discriminator.pth). Returns the nested
    tree (its leaf count is the JAX command's ``n_params``).

    Usage: ``python -m scream_tpu_torch convert --pth point-generator.pth
    --out weights/point --model point``.
    """
    import dataclasses

    import torch

    from scream_tpu_torch.config import ModelConfig
    from scream_tpu_torch.utils.checkpoint import save_params

    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    tree, state, sidecar = convert_state_dict(sd, model)
    if model == "disc":
        from scream_tpu_torch.models.gan import PatchDiscriminator

        net = PatchDiscriminator(**sidecar, device="cpu")
    else:
        from scream_tpu_torch.models import DEMTransformer, PointTransformer

        cls = DEMTransformer if model == "dem" else PointTransformer
        net = cls(dataclasses.replace(ModelConfig(), **sidecar), device="cpu")
    net.load_state_dict(state, strict=True)
    save_params(out_dir, state, sidecar)
    return tree


def tree_size(tree: Mapping) -> int:
    """Number of scalars in a nested tree of arrays."""
    return sum(tree_size(v) if isinstance(v, Mapping) else int(np.size(v))
               for v in tree.values())

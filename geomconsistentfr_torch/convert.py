"""Weights in and out of the port's RelightNet and PatchGAN (reference `.pth` layout).

The port's state dict IS the reference checkpoint's layout, so a reference
`.pth` loads directly. This module adds:

  * `load_checkpoint(path)`: a plain `torch.load` of a reference state dict.
  * `state_dict_from_jax_variables(variables)`: the JAX package's flax
    `{'params', 'batch_stats'}` (numpy arrays) of a RelightNet or a PatchGAN
    -> the port's state dict, the inverse of geomconsistentfr_tpu/convert.py:34-73:
      conv   (kh, kw, I, O) -> (O, I, kh, kw)
      deconv (kh, kw, I, O) -> flip spatial -> (I, O, kh, kw)
      linear (in, out)      -> (out, in)
      bn scale/bias, batch_stats mean/var -> weight/bias, running_mean/var.
  * `variables_from_state_dict(state)`: the inverse, a reference state dict
    -> the flax `{'params', 'batch_stats'}` tree of numpy arrays that
    geomconsistentfr_tpu/convert.py's `torch_state_to_variables` makes and
    `cli convert` writes as an orbax checkpoint.
  * `transfer_to_target_variant(state)`: embeds transfer-variant weights
    (1x1 bias-free shortcuts) into the target variant (3x3 with bias) as the
    centre tap with zero bias -- an identical function.
  * `adam_moments_from_optax(mu, nu)`: an optax Adam state's moments in the
    port's parameter names, so tests can hold the optimizers together.
  * the secondary models' weights carried across from the JAX package's
    flax parameters (HWIO kernels -> OIHW): `lpips_state_dict_from_jax`
    (the trunk in torchvision's `features.N` keys, the heads in the LPIPS
    library's `lin{i}.model.1.weight`), `dist2logit_state_dict_from_jax`
    (the 2AFC ranking net) and `s3fd_state_dict_from_jax` (face_alignment's
    s3fd.pth keys).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

SHORTCUT_NAMES = (
    "conv_shortcut_h1_out",
    "conv_shortcut_h2_out",
    "conv_shortcut_h3_out",
    "deconv_albedo_shortcut_all_features",
    "deconv_albedo_shortcut_h5_out",
    "deconv_albedo_shortcut_h6_out",
    "deconv_depth_shortcut_all_features",
    "deconv_depth_shortcut_h5_out",
    "deconv_depth_shortcut_h6_out",
)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference `.pth` state dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def state_dict_from_jax_variables(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """Flax RelightNet variables (numpy leaves) -> the port's state dict."""
    state: Dict[str, torch.Tensor] = {}

    def put(key, value):
        # A fresh C-ordered copy: flipped views have negative strides.
        state[key] = torch.from_numpy(np.array(value, order="C", copy=True))

    for module, leaves in variables["params"].items():
        for leaf, value in leaves.items():
            value = np.asarray(value, np.float32)
            if module.startswith("bn"):
                put(f"{module}.{'weight' if leaf == 'scale' else 'bias'}", value)
            elif leaf == "bias":
                put(f"{module}.bias", value)
            elif module.startswith("linear"):
                put(f"{module}.weight", value.T)
            elif module.startswith("deconv"):
                put(f"{module}.weight", value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
            else:
                put(f"{module}.weight", value.transpose(3, 2, 0, 1))
    for module, leaves in variables.get("batch_stats", {}).items():
        put(f"{module}.running_mean", np.asarray(leaves["mean"], np.float32))
        put(f"{module}.running_var", np.asarray(leaves["var"], np.float32))
        state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return state


def variables_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """A reference state dict (a RelightNet's or a PatchGAN's) -> flax
    {'params': ..., 'batch_stats': ...} with float32 numpy leaves
    (num_batches_tracked is dropped)."""
    params: Dict[str, dict] = {}
    batch_stats: Dict[str, dict] = {}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        value = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value, np.float32)
        if module.startswith("bn"):
            names = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                     "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
            if leaf not in names:
                raise ValueError(f"unexpected BatchNorm leaf: {key}")
            where, name = names[leaf]
            (params if where == "params" else batch_stats).setdefault(module, {})[name] = value
        elif leaf == "bias":
            params.setdefault(module, {})["bias"] = value
        elif leaf != "weight":
            raise ValueError(f"unexpected leaf: {key}")
        elif module.startswith("linear"):
            params.setdefault(module, {})["kernel"] = np.ascontiguousarray(value.T)
        elif module.startswith("deconv"):
            kernel = value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            params.setdefault(module, {})["kernel"] = np.ascontiguousarray(kernel)
        else:
            params.setdefault(module, {})["kernel"] = np.ascontiguousarray(value.transpose(2, 3, 1, 0))
    return {"params": params, "batch_stats": batch_stats}


def adam_moments_from_optax(mu: Mapping[str, Mapping], nu: Mapping[str, Mapping]):
    """An optax Adam state's `mu` and `nu` trees (numpy leaves, the flax
    parameter layout) -> two dicts keyed by the port's parameter names.

    The layout change is a permutation of each array (transposes and the
    deconvolutions' spatial flip), so each moment maps exactly as its
    parameter does. They compare with torch.optim.Adam's `exp_avg` and
    `exp_avg_sq` (train.adam_moments).
    """
    return state_dict_from_jax_variables({"params": mu}), state_dict_from_jax_variables({"params": nu})


def is_transfer_state(state: Mapping[str, torch.Tensor]) -> bool:
    """True when the state dict has the transfer variant's 1x1 shortcuts."""
    w = state.get("conv_shortcut_h1_out.weight")
    return w is not None and tuple(w.shape[2:]) == (1, 1)


def transfer_to_target_variant(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Embed a transfer-variant state dict into the target-variant layout."""
    out = dict(state)
    for name in SHORTCUT_NAMES:
        w = state[f"{name}.weight"]
        if tuple(w.shape[2:]) != (1, 1):
            raise ValueError(f"{name}.weight is not a 1x1 shortcut: {tuple(w.shape)}")
        padded = torch.zeros((*w.shape[:2], 3, 3), dtype=w.dtype)
        padded[:, :, 1, 1] = w[:, :, 0, 0]
        out[f"{name}.weight"] = padded
        # Conv weights are (O, I, ...), transposed-conv weights (I, O, ...).
        n_out = w.shape[1] if name.startswith("deconv") else w.shape[0]
        out[f"{name}.bias"] = torch.zeros((n_out,), dtype=w.dtype)
    return out


def _oihw(kernel) -> torch.Tensor:
    """A flax (kh, kw, I, O) kernel as torch's (O, I, kh, kw)."""
    return torch.from_numpy(np.array(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1), order="C", copy=True))


def _f32(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, np.float32, copy=True))


_FIRE_PARTS = {"squeeze": "squeeze", "expand1": "expand1x1", "expand3": "expand3x3"}


def lpips_state_dict_from_jax(params: Mapping[str, Mapping], net: str = "alex") -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS params (models/lpips.py: {'trunk': ..., 'lin{i}': ...}) -> the
    port's LPIPS state dict. The trunk's conv{i} is the i-th convolution of
    torchvision's `features` (alex, vgg); squeeze's fire{N}_{part} is features.N.{part}."""
    from geomconsistentfr_torch.models.lpips import _conv_prefixes

    state: Dict[str, torch.Tensor] = {}
    trunk = params["trunk"]
    if net == "squeeze":
        names = {"conv0": "0"}
        names.update({f"fire{n}_{ours}": f"{n}.{theirs}" for n in (3, 4, 6, 7, 9, 10, 11, 12)
                      for ours, theirs in _FIRE_PARTS.items()})
    else:
        names = {f"conv{i}": prefix for i, prefix in enumerate(_conv_prefixes(net))}
    for ours, prefix in names.items():
        state[f"trunk.features.{prefix}.weight"] = _oihw(trunk[ours]["kernel"])
        state[f"trunk.features.{prefix}.bias"] = _f32(trunk[ours]["bias"])
    i = 0
    while f"lin{i}" in params:
        state[f"lin{i}.model.1.weight"] = _oihw(params[f"lin{i}"]["kernel"])
        i += 1
    return state


def dist2logit_state_dict_from_jax(params: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """The JAX package's Dist2Logit params (fc0-fc2, 1x1 convs) -> the port's state dict."""
    state = {}
    for name, leaves in params.items():
        state[f"{name}.weight"] = _oihw(leaves["kernel"])
        state[f"{name}.bias"] = _f32(leaves["bias"])
    return state


def s3fd_state_dict_from_jax(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """The JAX package's S3FD variables ({'params': ...}) -> the port's state dict, which is
    face_alignment's s3fd.pth layout (`conv1_1.weight`, `conv3_3_norm.weight`, ...)."""
    state = {}
    for name, leaves in variables["params"].items():
        if "kernel" in leaves:
            state[f"{name}.weight"] = _oihw(leaves["kernel"])
            state[f"{name}.bias"] = _f32(leaves["bias"])
        else:  # L2Norm's scale
            state[f"{name}.weight"] = _f32(leaves["weight"])
    return state

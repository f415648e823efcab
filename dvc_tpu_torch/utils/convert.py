"""The weight bridge: dvc_tpu parameter trees -> the port's state dicts, and
the reference .pth helpers.

``vae_state_dict_from_jax`` and ``wavenet_state_dict_from_jax`` take the JAX
package's parameter trees as nested mappings of numpy arrays and return
state dicts with the reference checkpoints' names.  They invert
dvc_tpu/utils/torch_convert.py's name and layout map:

  flax Dense kernel (in, out)        -> torch Linear weight (out, in)
  flax Conv kernel (k, in, out)      -> torch Conv1d weight (out, in, k)
  LSTM w_ih/w_hh/b_ih/b_hh_l{n}[_reverse] -> weight_ih/.../bias_hh_l{n}[_reverse]
  bn scale/bias (params), mean/var (batch_stats)
                                     -> BatchNorm1d weight/bias, running_mean/var
  upsample up{j}_kernel (kf, 2s)     -> ConvTranspose2d weight (1, 1, kf, 2s)
                                        (kept in torch layout by dvc_tpu)

With them every test gives both packages the same weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1d(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: dict, prefix: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _lstm(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    for name, a in p.items():  # w_ih_l0_reverse -> weight_ih_l0_reverse
        kind, rest = name.split("_", 1)
        sd[f"{prefix}.{'weight' if kind == 'w' else 'bias'}_{rest}"] = _t(a)


def vae_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu DisentangledVAE (params, batch_stats) -> the port's state dict
    (the reference model/disentangled_vae.py names)."""
    enc, dec, post = params["encoder"], params["decoder"], params["postnet_mod"]
    enc_s, dec_s, post_s = (batch_stats["encoder"], batch_stats["decoder"],
                            batch_stats["postnet_mod"])
    sd: dict[str, torch.Tensor] = {}
    for i in range(3):
        _conv1d(sd, f"enc_modules.{i}.0.conv", enc[f"conv{i}"]["conv"])
        _bn(sd, f"enc_modules.{i}.1", enc[f"bn{i}"]["bn"], enc_s[f"bn{i}"]["bn"])
    _lstm(sd, "enc_lstm", enc["lstm"])
    _linear(sd, "enc_linear.linear_layer", enc["linear"]["dense"])
    _linear(sd, "style.linear_layer", enc["style"]["dense"])
    _linear(sd, "content.linear_layer", enc["content"]["dense"])

    _linear(sd, "dec_pre_linear1", dec["pre_linear1"]["dense"])
    _linear(sd, "dec_pre_linear2", dec["pre_linear2"]["dense"])
    _lstm(sd, "dec_lstm1", dec["lstm1"])
    for i in range(3):
        _conv1d(sd, f"dec_modules.{i}.0", dec[f"conv{i}"]["conv"])
        _bn(sd, f"dec_modules.{i}.1", dec[f"bn{i}"]["bn"], dec_s[f"bn{i}"]["bn"])
    _lstm(sd, "dec_lstm2", dec["lstm2"])
    _linear(sd, "dec_linear2.linear_layer", dec["linear2"]["dense"])

    n_post = sum(1 for k in post if k.startswith("conv"))
    for i in range(n_post):
        _conv1d(sd, f"postnet.convolutions.{i}.0.conv", post[f"conv{i}"]["conv"])
        _bn(sd, f"postnet.convolutions.{i}.1", post[f"bn{i}"]["bn"],
            post_s[f"bn{i}"]["bn"])
    return sd


def wavenet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu WaveNet params -> the port's state dict (the r9y9
    wavenet_vocoder names, weight norm already fused)."""
    sd: dict[str, torch.Tensor] = {}
    _conv1d(sd, "first_conv", params["first_conv"])
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        lp = params[f"layer{i}"]
        for name in ("conv", "conv1x1c", "conv1x1_skip", "conv1x1_out"):
            _conv1d(sd, f"conv_layers.{i}.{name}", lp[name])
    _conv1d(sd, "last_conv_layers.1", params["final1"])
    _conv1d(sd, "last_conv_layers.3", params["final2"])
    up = params["upsample"]
    for j in range(sum(1 for k in up if k.endswith("_kernel"))):
        sd[f"upsample_conv.{2 * j}.weight"] = _t(up[f"up{j}_kernel"])[None, None]
        sd[f"upsample_conv.{2 * j}.bias"] = _t(up[f"up{j}_bias"])
    return sd


def probe_weights_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The tools/ probes' weights (name -> array) -> torch tensors of the
    same dtype, bit for bit.  ``np.asarray`` of a JAX bfloat16 array is an
    ml_dtypes bfloat16 array, which ``torch.from_numpy`` rejects: it goes
    through its 16-bit pattern and ``.view(torch.bfloat16)``."""
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a.copy())
    return out


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A .pth state dict, unwrapped from a {"state_dict": ...} or
    {"model_state": ...} container."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model_state"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    return {k: torch.as_tensor(v) for k, v in ckpt.items()}


def fuse_weight_norm(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Replace every (weight_g, weight_v) pair with w = g * v / ||v||, the
    norm over all axes but the first (dvc_tpu torch_convert.fuse_weight_norm)."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            g = out.pop(k)
            v = out.pop(base + "weight_v")
            norm = torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim())), keepdim=True))
            out[base + "weight"] = g * v / torch.clamp(norm, min=1e-12)
    return out

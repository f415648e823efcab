"""The weight bridge between dvc_tpu parameter trees and the port's state
dicts, both ways, and the reference .pth helpers.

``vae_state_dict_from_jax``, ``wavenet_state_dict_from_jax``,
``istft_state_dict_from_jax``, ``speaker_encoder_state_dict_from_jax`` and
``autovc_state_dict_from_jax`` take the JAX package's parameter trees as
nested mappings of numpy arrays and return state dicts with the reference
checkpoints' names (the iSTFT vocoder has no reference: its names are the
port's modules; nor do ``feature_selection_state_dict_from_jax`` and
``adversary_state_dict_from_jax``, whose flax Dense names are the port's
Linear names; nor does AutoVC, whose port modules carry dvc_tpu's
names); the ``*_tree_from_state_dict`` functions go back,
and ``optax_adam_from_torch`` / ``torch_adam_from_optax`` carry Adam's
moments and step between torch and optax.  The map is
dvc_tpu/utils/torch_convert.py's, inverted:

  flax Dense kernel (in, out)        -> torch Linear weight (out, in)
  flax Conv kernel (k, in, out)      -> torch Conv1d weight (out, in, k)
  LSTM w_ih/w_hh/b_ih/b_hh_l{n}[_reverse] -> weight_ih/.../bias_hh_l{n}[_reverse]
  bn scale/bias (params), mean/var (batch_stats)
                                     -> BatchNorm1d weight/bias, running_mean/var
  LayerNorm scale/bias               -> LayerNorm weight/bias
  upsample up{j}_kernel (kf, 2s)     -> ConvTranspose2d weight (1, 1, kf, 2s)
                                        (kept in torch layout by dvc_tpu)

With them every test gives both packages the same weights, and each package
reads the other's checkpoints (train/checkpoint.py).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def keeps_torch_layout(name: str) -> bool:
    """Whether dvc_tpu keeps the tensor of state-dict name ``name`` in
    torch's layout (the LSTM weights); every other tensor's axes are
    reversed (Linear and Conv1d kernels; 1-D tensors are unchanged)."""
    return name.rsplit(".", 1)[-1].startswith(("weight_ih", "weight_hh"))


def flax_shape(name: str, shape: Sequence[int]) -> tuple[int, ...]:
    """A shape, or a block's index in a grid, of tensor ``name`` in
    dvc_tpu's layout."""
    shape = tuple(shape)
    return shape if keeps_torch_layout(name) else shape[::-1]


def flax_array(name: str, t: torch.Tensor) -> np.ndarray:
    """Tensor ``name``, or a block of it, in dvc_tpu's layout, float32 on
    the host, as the map above carries whole tensors."""
    a = t.detach().to("cpu", torch.float32)
    return (a if keeps_torch_layout(name) else a.permute(*reversed(range(a.dim())))).numpy()


def _linear(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _linear_inv(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T.copy()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _conv1d(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1d_inv(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 1, 0).copy()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _bn(sd: dict, prefix: str, p: Mapping[str, Any], s: Mapping[str, Any] | None) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    if s is not None:
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _lstm(sd: dict, prefix: str, p: Mapping[str, Any]) -> None:
    for name, a in p.items():  # w_ih_l0_reverse -> weight_ih_l0_reverse
        kind, rest = name.split("_", 1)
        sd[f"{prefix}.{'weight' if kind == 'w' else 'bias'}_{rest}"] = _t(a)


def _lstm_inv(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    p = {}
    for key, a in sd.items():  # weight_ih_l0_reverse -> w_ih_l0_reverse
        if key.startswith(prefix + "."):
            kind, rest = key[len(prefix) + 1:].split("_", 1)
            p[f"{'w' if kind == 'weight' else 'b'}_{rest}"] = _np(a)
    return p


def _vae_layout(n_post: int) -> list[tuple[str, str, tuple[str, ...]]]:
    """(kind, state-dict prefix, dvc_tpu tree path) of every VAE layer;
    both directions of the bridge walk this one table."""
    out = []
    for i in range(3):
        out += [("conv", f"enc_modules.{i}.0.conv", ("encoder", f"conv{i}", "conv")),
                ("bn", f"enc_modules.{i}.1", ("encoder", f"bn{i}", "bn"))]
    out += [("lstm", "enc_lstm", ("encoder", "lstm")),
            ("linear", "enc_linear.linear_layer", ("encoder", "linear", "dense")),
            ("linear", "style.linear_layer", ("encoder", "style", "dense")),
            ("linear", "content.linear_layer", ("encoder", "content", "dense")),
            ("linear", "dec_pre_linear1", ("decoder", "pre_linear1", "dense")),
            ("linear", "dec_pre_linear2", ("decoder", "pre_linear2", "dense")),
            ("lstm", "dec_lstm1", ("decoder", "lstm1"))]
    for i in range(3):
        out += [("conv", f"dec_modules.{i}.0", ("decoder", f"conv{i}", "conv")),
                ("bn", f"dec_modules.{i}.1", ("decoder", f"bn{i}", "bn"))]
    out += [("lstm", "dec_lstm2", ("decoder", "lstm2")),
            ("linear", "dec_linear2.linear_layer", ("decoder", "linear2", "dense"))]
    for i in range(n_post):
        out += [("conv", f"postnet.convolutions.{i}.0.conv", ("postnet_mod", f"conv{i}", "conv")),
                ("bn", f"postnet.convolutions.{i}.1", ("postnet_mod", f"bn{i}", "bn"))]
    return out


def _get(tree: Mapping[str, Any], path: tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def vae_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any] | None
                            ) -> dict[str, torch.Tensor]:
    """dvc_tpu DisentangledVAE (params, batch_stats) -> the port's state dict
    (the reference model/disentangled_vae.py names).  With batch_stats None
    the BatchNorm running statistics are left out (a tree of Adam moments
    has params only)."""
    n_post = sum(1 for k in params["postnet_mod"] if k.startswith("conv"))
    sd: dict[str, torch.Tensor] = {}
    for kind, prefix, path in _vae_layout(n_post):
        p = _get(params, path)
        if kind == "bn":
            _bn(sd, prefix, p, None if batch_stats is None else _get(batch_stats, path))
        else:
            {"conv": _conv1d, "linear": _linear, "lstm": _lstm}[kind](sd, prefix, p)
    return sd


def vae_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """The port's VAE state dict -> dvc_tpu's (params, batch_stats) trees of
    float32 numpy arrays; the inverse of vae_state_dict_from_jax.  A state
    dict without running statistics (Adam's moments, keyed by parameter
    name) gives an empty batch_stats."""
    n_post = sum(1 for k in sd if k.startswith("postnet.convolutions.")
                 and k.endswith(".0.conv.weight"))
    params: dict = {}
    stats: dict = {}
    for kind, prefix, path in _vae_layout(n_post):
        if kind == "bn":
            _put(params, path, {"scale": _np(sd[f"{prefix}.weight"]),
                                "bias": _np(sd[f"{prefix}.bias"])})
            if f"{prefix}.running_mean" in sd:
                _put(stats, path, {"mean": _np(sd[f"{prefix}.running_mean"]),
                                   "var": _np(sd[f"{prefix}.running_var"])})
        else:
            inv = {"conv": _conv1d_inv, "linear": _linear_inv, "lstm": _lstm_inv}[kind]
            _put(params, path, inv(sd, prefix))
    return params, stats


def _dense_state_dict(params: Mapping[str, Any], names: tuple[str, ...]) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for name in names:
        _linear(sd, name, params[name])
    return sd


def feature_selection_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu FeatureSelection params -> the port's FeatureSelection state dict."""
    return _dense_state_dict(params, ("ln1", "ln2", "weight", "cls_linear", "prediction"))


def adversary_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu SpeakerAdversary params -> the port's SpeakerAdversary state dict."""
    return _dense_state_dict(params, ("fc0", "fc1", "out"))


_WAVENET_CONVS = ("conv", "conv1x1c", "conv1x1_skip", "conv1x1_out")


def wavenet_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu WaveNet params -> the port's state dict (the r9y9
    wavenet_vocoder names, weight norm already fused)."""
    sd: dict[str, torch.Tensor] = {}
    _conv1d(sd, "first_conv", params["first_conv"])
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        lp = params[f"layer{i}"]
        for name in _WAVENET_CONVS:
            _conv1d(sd, f"conv_layers.{i}.{name}", lp[name])
    _conv1d(sd, "last_conv_layers.1", params["final1"])
    _conv1d(sd, "last_conv_layers.3", params["final2"])
    up = params["upsample"]
    for j in range(sum(1 for k in up if k.endswith("_kernel"))):
        sd[f"upsample_conv.{2 * j}.weight"] = _t(up[f"up{j}_kernel"])[None, None]
        sd[f"upsample_conv.{2 * j}.bias"] = _t(up[f"up{j}_bias"])
    return sd


def wavenet_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's WaveNet state dict (weight norm fused) -> dvc_tpu's params
    tree; the inverse of wavenet_state_dict_from_jax."""
    params: dict = {"first_conv": _conv1d_inv(sd, "first_conv")}
    n_layers = sum(1 for k in sd if k.startswith("conv_layers.") and k.endswith(".conv.weight"))
    for i in range(n_layers):
        params[f"layer{i}"] = {name: _conv1d_inv(sd, f"conv_layers.{i}.{name}")
                               for name in _WAVENET_CONVS}
    params["final1"] = _conv1d_inv(sd, "last_conv_layers.1")
    params["final2"] = _conv1d_inv(sd, "last_conv_layers.3")
    up = {}
    n_up = sum(1 for k in sd if k.startswith("upsample_conv.") and k.endswith(".weight"))
    for j in range(n_up):
        up[f"up{j}_kernel"] = _np(sd[f"upsample_conv.{2 * j}.weight"])[0, 0].copy()
        up[f"up{j}_bias"] = _np(sd[f"upsample_conv.{2 * j}.bias"])
    params["upsample"] = up
    return params


def _istft_layout(n_blocks: int) -> list[tuple[str, str, tuple[str, ...]]]:
    """(kind, state-dict prefix, dvc_tpu tree path) of every iSTFT vocoder
    layer; both directions of the bridge walk this one table."""
    out = [("conv", "stem", ("stem",)), ("ln", "stem_norm", ("stem_norm",))]
    for i in range(n_blocks):
        out += [("conv", f"blocks.{i}.conv_a", (f"block{i}", "conv_a")),
                ("conv", f"blocks.{i}.conv_b", (f"block{i}", "conv_b"))]
    return out + [("ln", "head_norm", ("head_norm",)), ("conv", "mag_head", ("mag_head",)),
                  ("conv", "phase_head", ("phase_head",))]


def istft_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu ISTFTVocoder params -> the port's ISTFTVocoder state dict."""
    sd: dict[str, torch.Tensor] = {}
    for kind, prefix, path in _istft_layout(sum(1 for k in params if k.startswith("block"))):
        p = _get(params, path)
        if kind == "ln":
            sd[f"{prefix}.weight"] = _t(p["scale"])
            sd[f"{prefix}.bias"] = _t(p["bias"])
        else:
            _conv1d(sd, prefix, p)
    return sd


def istft_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's ISTFTVocoder state dict -> dvc_tpu's params tree; the
    inverse of istft_state_dict_from_jax."""
    n_blocks = sum(1 for k in sd if k.startswith("blocks.") and k.endswith(".conv_a.weight"))
    params: dict = {}
    for kind, prefix, path in _istft_layout(n_blocks):
        if kind == "ln":
            _put(params, path, {"scale": _np(sd[f"{prefix}.weight"]),
                                "bias": _np(sd[f"{prefix}.bias"])})
        else:
            _put(params, path, _conv1d_inv(sd, prefix))
    return params


def speaker_encoder_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """dvc_tpu SpeakerEncoder params -> the port's SpeakerEncoder state dict."""
    sd: dict[str, torch.Tensor] = {}
    _lstm(sd, "lstm", params["lstm"])
    _linear(sd, "linear", params["linear"])
    for name in ("similarity_weight", "similarity_bias"):
        sd[name] = _t(params[name])
    return sd


def speaker_encoder_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's SpeakerEncoder state dict -> dvc_tpu's params tree; the
    inverse of speaker_encoder_state_dict_from_jax."""
    return {"lstm": _lstm_inv(sd, "lstm"), "linear": _linear_inv(sd, "linear"),
            "similarity_weight": _np(sd["similarity_weight"]),
            "similarity_bias": _np(sd["similarity_bias"])}


def _autovc_layout(proposed: bool) -> list[tuple[str, tuple[str, ...]]]:
    """(kind, dvc_tpu tree path) of every layer of AutoVC / AutoVCF0, or of
    ProposedAutoVC; the port's modules carry the same names (see
    _autovc_prefix), so both directions walk this one table."""
    def convs(scope, conv, bn, n):
        return [x for i in range(n) for x in (("conv", scope + (f"{conv}{i}", "conv")),
                                              ("bn", scope + (f"{bn}{i}", "bn")))]
    if proposed:
        out = (convs((), "enc_conv", "enc_bn", 3)
               + [("lstm", ("enc_lstm",)), ("linear", ("latent_code", "dense")),
                  ("linear", ("dec_linear", "dense")), ("lstm", ("dec_lstm1",))]
               + convs((), "dec_conv", "dec_bn", 3)
               + [("lstm", ("dec_lstm2",)), ("linear", ("linear_projection", "dense"))])
    else:
        out = (convs(("encoder",), "conv", "bn", 3)
               + [("lstm", ("encoder", "lstm")), ("lstm", ("decoder", "lstm1"))]
               + convs(("decoder",), "conv", "bn", 3)
               + [("lstm", ("decoder", "lstm2")),
                  ("linear", ("decoder", "linear_projection", "dense"))])
    return out + convs(("postnet",), "conv", "bn", 5)


def _autovc_prefix(kind: str, path: tuple[str, ...]) -> str:
    """A tree path's state-dict prefix: a ConvNorm's conv is ``.conv`` in
    both, a LinearNorm's dense is the port's ``.linear_layer``, and flax's
    ``bn`` level is the port's BatchNorm itself."""
    if kind == "bn":
        return ".".join(path[:-1])
    if kind == "linear":
        return ".".join(path[:-1] + ("linear_layer",))
    return ".".join(path)


def autovc_state_dict_from_jax(params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any] | None
                               ) -> dict[str, torch.Tensor]:
    """dvc_tpu AutoVC, AutoVCF0 or ProposedAutoVC (params, batch_stats) ->
    the port's state dict of the same generator; with batch_stats None the
    running statistics are left out (a tree of Adam moments)."""
    sd: dict[str, torch.Tensor] = {}
    for kind, path in _autovc_layout("encoder" not in params):
        prefix, p = _autovc_prefix(kind, path), _get(params, path)
        if kind == "bn":
            _bn(sd, prefix, p, None if batch_stats is None else _get(batch_stats, path))
        else:
            {"conv": _conv1d, "linear": _linear, "lstm": _lstm}[kind](sd, prefix, p)
    return sd


def autovc_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """The port's AutoVC-family state dict -> dvc_tpu's (params,
    batch_stats); the inverse of autovc_state_dict_from_jax.  A state dict
    without running statistics gives an empty batch_stats."""
    params: dict = {}
    stats: dict = {}
    for kind, path in _autovc_layout(not any(k.startswith("encoder.") for k in sd)):
        prefix = _autovc_prefix(kind, path)
        if kind == "bn":
            _put(params, path, {"scale": _np(sd[f"{prefix}.weight"]),
                                "bias": _np(sd[f"{prefix}.bias"])})
            if f"{prefix}.running_mean" in sd:
                _put(stats, path, {"mean": _np(sd[f"{prefix}.running_mean"]),
                                   "var": _np(sd[f"{prefix}.running_var"])})
        else:
            inv = {"conv": _conv1d_inv, "linear": _linear_inv, "lstm": _lstm_inv}[kind]
            _put(params, path, inv(sd, prefix))
    return params, stats


def vae_tree_paths(sd: Mapping[str, Any]) -> dict[str, tuple[str, tuple[str, ...]]]:
    """State-dict name -> ("params" or "batch_stats", the path in dvc_tpu's
    tree) for every VAE parameter and BatchNorm statistic of ``sd`` (the
    names vae_tree_from_state_dict maps; num_batches_tracked has none)."""
    n_post = sum(1 for k in sd if k.startswith("postnet.convolutions.")
                 and k.endswith(".0.conv.weight"))
    out = {}
    for kind, prefix, path in _vae_layout(n_post):
        if kind == "bn":
            out.update({f"{prefix}.weight": ("params", path + ("scale",)),
                        f"{prefix}.bias": ("params", path + ("bias",)),
                        f"{prefix}.running_mean": ("batch_stats", path + ("mean",)),
                        f"{prefix}.running_var": ("batch_stats", path + ("var",))})
        elif kind == "lstm":
            for key in sd:
                if key.startswith(prefix + "."):
                    what, rest = key[len(prefix) + 1:].split("_", 1)
                    out[key] = ("params", path + (f"{'w' if what == 'weight' else 'b'}_{rest}",))
        else:
            out.update({f"{prefix}.weight": ("params", path + ("kernel",)),
                        f"{prefix}.bias": ("params", path + ("bias",))})
    return {k: v for k, v in out.items() if k in sd}


def optax_adam_from_torch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          tree_of: Callable[[dict], dict]) -> dict:
    """torch Adam's state -> the state dict of dvc_tpu's ``optax.adam``
    (chain(scale_by_adam, scale_by_learning_rate)): ``{"0": {"count",
    "mu", "nu"}, "1": {}}``.  exp_avg / exp_avg_sq become mu / nu through
    ``tree_of`` (a state dict keyed by parameter name -> dvc_tpu's params
    tree), so they take the same transposes as their weights; the step
    becomes the int32 count.  An optimizer that has not stepped gives
    zeros, as optax's init."""
    if [id(p) for g in optimizer.param_groups for p in g["params"]] != \
            [id(p) for p in model.parameters()]:
        raise ValueError("the optimizer does not hold exactly the model's parameters")
    state = optimizer.state_dict()["state"]
    mu, nu, count = {}, {}, 0
    for i, (name, p) in enumerate(model.named_parameters()):
        st = state.get(i)
        if st is None:
            mu[name] = nu[name] = torch.zeros_like(p)
        else:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            count = int(st["step"])
    return {"0": {"count": np.array(count, np.int32), "mu": tree_of(mu), "nu": tree_of(nu)},
            "1": {}}


def torch_adam_from_optax(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          opt_state: Mapping[str, Any],
                          state_dict_of: Callable[[Mapping[str, Any]], dict]) -> int:
    """Load dvc_tpu's ``optax.adam`` state into a torch Adam built over
    ``model.parameters()``: mu / nu (through ``state_dict_of``, dvc_tpu's
    params tree -> a state dict by name) become exp_avg / exp_avg_sq, the
    count becomes every parameter's step.  Returns the count."""
    adam = opt_state["0"]
    count = int(np.asarray(adam["count"]))
    mu, nu = state_dict_of(adam["mu"]), state_dict_of(adam["nu"])
    state = {}
    if count > 0:
        for i, (name, _) in enumerate(model.named_parameters()):
            state[i] = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
    return count


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

"""The iSTFT vocoder in the port against dvc_tpu on the CPU, at dvc_tpu's
TINY size (48 channels, 2 blocks; tests/test_istft_vocoder.py): the
forward (spectrum and waveform), the untrained model's pinv prior,
synthesize's length rule, the multi-resolution STFT loss, one train step,
clip + AdamW against optax, make_istft_vocoder's batches, and the
checkpoints both ways.  The same seeded numpy inputs and weights (through
utils/convert) go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.convert import vocode as jvocode
from dvc_tpu.models import istft_vocoder as jiv
from dvc_tpu.train import istft_vocoder_trainer as jit_
from dvc_tpu_torch.config import AudioConfig, ISTFTVocoderConfig
from dvc_tpu_torch.convert import griffinlim as pgl
from dvc_tpu_torch.convert.vocode import load_istft_params, make_istft_vocoder
from dvc_tpu_torch.models import istft_vocoder as piv
from dvc_tpu_torch.train import istft_vocoder_trainer as pit
from dvc_tpu_torch.utils.convert import istft_state_dict_from_jax, istft_tree_from_state_dict

TINY_KW = dict(channels=48, blocks=2, dilation_cycle=(1, 2))
JTINY, TINY = JC.ISTFTVocoderConfig(**TINY_KW), ISTFTVocoderConfig(**TINY_KW)
JAUDIO, AUDIO = JC.AudioConfig(), AudioConfig()
# spectrum and waveform, max |diff| over the reference's peak magnitude:
# float32 convolutions and FFTs in another order, the phase a ratio
PEAK_RTOL = 1e-4
# scalar losses: float32 sums over ~1e5 STFT bins in another order
TERM_RTOL = 1e-5
# gradients (here Adam's first moment, 0.1 x the clipped gradient), max
# |diff| over the parameter's max: tests/test_torch_port_train.py's limit
GRAD_RTOL = 1e-3


def _jax_vars(seed=0, t=12, mag_scale=0.02):
    """dvc_tpu's init, with the zero-init magnitude head given seeded
    values so that it is exercised."""
    model = jiv.ISTFTVocoder(JTINY, JAUDIO)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 80, t)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    k = params["mag_head"]["kernel"]
    params["mag_head"]["kernel"] = (np.random.RandomState(seed).randn(*k.shape)
                                    * mag_scale).astype(np.float32)
    return model, params


def _port(params):
    m = piv.ISTFTVocoder(TINY, AUDIO)
    m.load_state_dict(istft_state_dict_from_jax(params))
    return m


def _mel(seed, b=2, t=12):
    return np.random.RandomState(seed).rand(b, 80, t).astype(np.float32)


def _peak_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def test_forward_and_synthesis_match_dvc_tpu():
    jm, params = _jax_vars()
    mel = _mel(0)
    model = _port(params)
    with torch.no_grad():
        spec = model(torch.from_numpy(mel))
        wav = piv.synthesize(model, torch.from_numpy(mel), 12 * 256)
    jspec = np.asarray(jm.apply({"params": params}, jnp.asarray(mel)))
    jwav = np.asarray(jiv.synthesize(jm, {"params": params}, jnp.asarray(mel), 12 * 256))
    assert spec.dtype == torch.complex64 and spec.shape == jspec.shape == (2, 12, 513)
    assert _peak_err(spec.numpy(), jspec) <= PEAK_RTOL
    assert wav.shape == jwav.shape == (2, 12 * 256)
    assert _peak_err(wav.numpy(), jwav) <= PEAK_RTOL


def test_untrained_model_is_the_pinv_prior():
    """The port's own init: the magnitude head starts at zero, so |spec| is
    the pinv-mel prior (+1e-5, clipped to [e^-11.5, e^6]) and the phase
    unit; conv kernels are lecun-normal, biases zero, norms ones/zeros."""
    torch.manual_seed(3)
    model = piv.ISTFTVocoder(TINY, AUDIO)
    mel = torch.from_numpy(_mel(1, b=1, t=8))
    with torch.no_grad():
        spec = model(mel)
    prior = pgl.mel_to_stft_magnitude(mel, AUDIO).numpy()
    want = np.clip(prior + 1e-5, np.exp(-11.5), np.exp(6.0))
    np.testing.assert_allclose(np.abs(spec.numpy()), want, rtol=1e-5, atol=1e-9)
    assert not model.mag_head.weight.any() and not model.mag_head.bias.any()
    w = model.blocks[0].conv_a.weight
    fan_in = w.shape[1] * w.shape[2]
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert not model.stem.bias.any() and torch.equal(model.stem_norm.weight,
                                                      torch.ones(48))
    assert model.stem_norm.eps == 1e-6


def test_synthesize_length_rule():
    _, params = _jax_vars()
    model = _port(params)
    mel = torch.from_numpy(_mel(2, b=1, t=10))
    with torch.no_grad():
        assert piv.synthesize(model, mel).shape == (
            1, pgl.default_inversion_length(10, AUDIO))
        assert piv.synthesize(model, mel, 10 * 256).shape == (1, 2560)
    with pytest.raises(ValueError, match="exceeds the 2560 samples"):
        piv.synthesize(model, mel, 10 * 256 + 1)


def test_mrstft_loss_matches_dvc_tpu():
    rng = np.random.RandomState(4)
    target = (0.3 * np.sin(np.arange(2 * 6000).reshape(2, 6000) * 0.07)
              + 0.05 * rng.randn(2, 6000)).astype(np.float32)
    pred = (target + 0.1 * rng.randn(2, 6000)).astype(np.float32)
    want = float(jit_.multi_resolution_stft_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = pit.multi_resolution_stft_loss(torch.from_numpy(pred), torch.from_numpy(target))
    assert abs(got.item() - want) <= TERM_RTOL * abs(want)
    same = torch.from_numpy(target)
    assert pit.multi_resolution_stft_loss(same, same.clone()).item() == 0.0


def _optax_chain():
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4, weight_decay=1e-5))


def test_clip_adamw_matches_optax():
    """Fed gradients over three steps, with global norms above and below 1
    (the clip's two sides), against optax.chain(clip_by_global_norm(1.0),
    adamw(2e-4, weight_decay=1e-5)) on two parameters."""
    rng = np.random.RandomState(5)
    p0 = [rng.randn(6, 4).astype(np.float32), rng.randn(3).astype(np.float32)]
    scales = (3.0, 0.01, 0.5)
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in p0] for s in scales]
    norms = [np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs)) for gs in grads]
    assert norms[0] > 1 and norms[1] < 1 and norms[2] > 1
    tx = _optax_chain()
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = pit.ClipAdamW(tp, lr=2e-4)
    for gs in grads:
        upd, js = tx.update([jnp.asarray(g) for g in gs], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for p, j in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    for m, j in zip(opt.mu, js[1][0].mu):
        np.testing.assert_allclose(m.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9)


def _tone_batch(t_frames=16, floor=0.0):
    """Two two-tone wavs and their mels; ``floor`` adds seeded noise of that
    std.  Without one, most STFT bins of a pure tone hold FFT rounding noise
    (below ~1e-6 of the peak), whose logarithm, which the MR-STFT loss
    takes, differs between any two FFT libraries."""
    x = np.arange(t_frames * 256) / 16000
    wav = np.stack([0.5 * np.sin(2 * np.pi * f * x) + 0.2 * np.sin(4 * np.pi * f * x)
                    for f in (220.0, 310.0)])
    wav = (wav + floor * np.random.RandomState(8).randn(*wav.shape)).astype(np.float32)
    from dvc_tpu_torch.ops.mel import melspectrogram
    mel = melspectrogram(torch.from_numpy(wav), AUDIO)[..., :t_frames].numpy()
    return mel, wav


def test_train_step_matches_make_istft_step():
    """One step of dvc_tpu's make_istft_step and of the port's from the
    same weights and batch: the total, MR-STFT and L1 terms, and the
    clipped gradient as Adam's first moment holds it (0.1 g)."""
    jm, params = _jax_vars(t=16)
    mel, wav = _tone_batch(floor=0.01)
    tx = _optax_chain()
    jstate = jit_.ISTFTVocState(step=jnp.zeros((), jnp.int32),
                                params=jax.tree_util.tree_map(jnp.asarray, params),
                                opt_state=tx.init(params))
    jstate, total, mrstft, l1 = jit_.make_istft_step(jm, tx)(jstate, jnp.asarray(mel),
                                                              jnp.asarray(wav))
    model = _port(params).train()
    opt = pit.ClipAdamW(model.parameters(), lr=2e-4)
    got = pit.make_istft_step(model, opt)(torch.from_numpy(mel), torch.from_numpy(wav))
    for g, w in zip(got, (total, mrstft, l1)):
        assert abs(g.item() - float(w)) <= TERM_RTOL * abs(float(w)), (g.item(), float(w))
    jmu = istft_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jstate.opt_state[1][0].mu))
    for (n, _), m in zip(model.named_parameters(), opt.mu):
        want = jmu[n]
        err = (m - want).abs().max().item() / want.abs().max().item()
        assert err <= GRAD_RTOL, (n, err)


def test_device_constants_are_cached_and_serve_training():
    """The step's windows, overlap norm and pinv are copied to the device
    once (utils/device.device_constant): the same tensor comes back, equal
    to its numpy constant; one first made while serving, in inference
    mode, goes through a train step's backward; the pinv prior follows a
    float64 mel's type and keeps a float32 mel's."""
    from dvc_tpu_torch.ops.stft import _window
    from dvc_tpu_torch.utils.device import device_constant

    with torch.inference_mode():
        pgl.istft(pgl.mel_to_stft_magnitude(torch.from_numpy(_mel(5)), AUDIO)
                  .to(torch.complex64), 12 * AUDIO.hop_size, AUDIO)
    win = device_constant(_window, ("hann", 512), torch.device("cpu"))
    assert win is device_constant(_window, ("hann", 512), torch.device("cpu"))
    np.testing.assert_array_equal(win.numpy(), _window("hann", 512))
    assert not win.is_inference()
    mel, wav = _tone_batch(floor=0.01)
    model = _port(_jax_vars(t=16)[1]).train()
    terms = pit.make_istft_step(model, pit.ClipAdamW(model.parameters()))(
        torch.from_numpy(mel), torch.from_numpy(wav))
    assert all(np.isfinite(t.item()) for t in terms)
    m = torch.from_numpy(_mel(6))
    assert pgl.mel_to_stft_magnitude(m, AUDIO).dtype == torch.float32
    p64 = pgl.mel_to_stft_magnitude(m.double(), AUDIO)
    assert p64.dtype == torch.float64
    np.testing.assert_allclose(p64.numpy(), pgl.mel_to_stft_magnitude(m, AUDIO).numpy(),
                               rtol=1e-4, atol=1e-4 * p64.abs().max().item())


def test_training_lowers_the_loss():
    """The port's trainer overfits a two-tone batch (dvc_tpu's
    test_overfits_a_tone, at its lr and steps)."""
    mel, wav = _tone_batch()
    tr = pit.ISTFTVocoderTrainer(TINY, lr=1e-3, device="cpu")
    losses = tr.train_steps(((mel, wav) for _ in range(60)), 60, logging_func=lambda *a: None)
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_make_istft_vocoder_batch_matches_dvc_tpu(tmp_path):
    """Both packages' make_istft_vocoder on one msgpack (dvc_tpu's trainer
    wrote it), mels of 10, 7 and 40 frames in one batch and one alone, and
    a 64-frame mel, which fills its bucket: its last samples sit at the
    overlap-add's edge, where both packages amplify them alike."""
    jtr = jit_.ISTFTVocoderTrainer(JTINY, seed=2)
    mel, wav = _tone_batch()
    jtr.train_steps(iter([(mel, wav)] * 2), 2, logging_func=lambda *a: None)
    path = jtr.save(str(tmp_path), "t")
    jvoc = jvocode.make_istft_vocoder(path, cfg=JTINY)
    pvoc = make_istft_vocoder(path, cfg=TINY, device="cpu")
    mels = [np.random.RandomState(i).rand(80, n).astype(np.float32)
            for i, n in ((0, 10), (1, 7), (2, 40))]
    want, got = jvoc.batch(mels), pvoc.batch(mels)
    assert [len(w) for w in got] == [len(w) for w in want] == [2560, 1792, 10240]
    for g, w in zip(got, want):
        assert _peak_err(g, w) <= PEAK_RTOL
    solo = pvoc(mels[1])
    assert solo.shape == (1792,) and _peak_err(solo, jvoc(mels[1])) <= PEAK_RTOL
    assert pvoc.batch([]) == []
    full = np.random.RandomState(3).rand(80, 64).astype(np.float32)
    got, want = pvoc(full), jvoc(full)
    assert got.shape == want.shape == (64 * 256,) and _peak_err(got, want) <= PEAK_RTOL
    edge = np.abs(want[-8:]).max() / np.abs(want[:-256]).max()
    assert edge > 5, edge


def test_checkpoints_both_ways(tmp_path):
    """The port's save is byte for byte what dvc_tpu's
    ISTFTVocoderTrainer.save writes for the same parameters and step; dvc_tpu
    reads it, and the port reads dvc_tpu's."""
    mel, wav = _tone_batch()
    tr = pit.ISTFTVocoderTrainer(TINY, device="cpu")
    tr.train_steps(iter([(mel, wav)] * 2), 2, logging_func=lambda *a: None)
    path = tr.save(str(tmp_path / "port"))
    assert path.endswith("istft_voc_step000000002.msgpack")
    port_tree = istft_tree_from_state_dict(tr.model.state_dict())

    jtr = jit_.ISTFTVocoderTrainer(JTINY)
    jtr.train_steps(iter([(mel, wav)]), 1, logging_func=lambda *a: None)
    jtr.state = jtr.state.replace(
        step=jnp.asarray(2, jnp.int32),
        params=jax.tree_util.tree_map(lambda _, b: jnp.asarray(b), jtr.state.params,
                                      port_tree))
    jpath = jtr.save(str(tmp_path / "jax"))
    with open(path, "rb") as f, open(jpath, "rb") as g:
        data = f.read()
        assert data == g.read()
    assert data == serialization.to_bytes({"params": jtr.state.params})

    jvoc = jvocode.make_istft_vocoder(path, cfg=JTINY)  # dvc_tpu reads the port's
    m = _mel(6, b=1, t=9)[0]
    mine = make_istft_vocoder(path, cfg=TINY, device="cpu")
    assert _peak_err(mine(m), jvoc(m)) <= PEAK_RTOL
    sd = load_istft_params(jpath)  # and the port reads dvc_tpu's
    for k, v in tr.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    # an untrained dvc_tpu save (its dicts in init order, not sorted)
    sd2 = load_istft_params(jit_.ISTFTVocoderTrainer(JTINY, seed=1).save(str(tmp_path / "j2")))
    piv.ISTFTVocoder(TINY, AUDIO).load_state_dict(sd2)  # strict

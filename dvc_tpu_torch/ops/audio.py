"""Waveform-domain ops (port of dvc_tpu/ops/audio.py): volume normalization,
peak rescaling, resampling, the two VAD detectors and the silence trim,
mu-law.

Resampling is rational polyphase by up/down with a windowed-sinc filter:
the role of librosa.resample at reference preprocessing/encoder/audio.py:44.
dvc_tpu writes it as one ``conv_general_dilated`` whose input dilation is
the upsample; here the upsample is explicit zero-stuffing followed by a
strided ``F.conv1d``, which is the same sum.

The VAD detectors feed the reference's smoothing and dilation chain
(trim_long_silences, encoder/audio.py:78-118).  ``gmm_vad_mask`` (the
default detector) is dvc_tpu's adaptive dual-GMM detector with WebRTC VAD's
architecture (see dvc_tpu/ops/audio.py's module docstring for how it
departs from webrtcvad).  dvc_tpu runs its frame recurrence as a
``lax.scan``; here the band features are computed on the waveform's device
(one rFFT over all frames and one matmul) and the recurrence, six bands by
two mixture components a frame, runs as a loop of float32 torch ops on the
host, where such small ops cost a few microseconds and a device launch
costs more.  ``energy_vad_mask`` is the fixed-threshold RMS detector.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _sinc_kernel(up: int, down: int, num_zeros: int = 16, rolloff: float = 0.945) -> np.ndarray:
    """Windowed-sinc polyphase filter for rational resampling by up/down
    (dvc_tpu's, bit for bit)."""
    cutoff = rolloff * 0.5 / max(up, down)
    half = int(np.ceil(num_zeros / (2 * cutoff)))
    n = np.arange(-half, half + 1, dtype=np.float64)
    x = 2 * cutoff * n
    sinc = np.sinc(x)
    win = np.hanning(len(n) + 2)[1:-1]
    kernel = 2 * cutoff * sinc * win * up
    return kernel.astype(np.float32)


def resample_poly(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """(..., T) -> (..., ceil(T * up / down)) float32, on the waveform's
    device, with up/down = target_sr/orig_sr in lowest terms."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    kernel = torch.from_numpy(_sinc_kernel(up, down)).to(wav.device)
    pad = kernel.numel() // 2

    batch_shape = wav.shape[:-1]
    t = wav.shape[-1]
    x = wav.to(torch.float32).reshape(-1, 1, t)
    out_len = -(-t * up // down)
    # output o reads [o*down - pad, o*down + pad] of the ((t-1)*up + 1)-long
    # zero-stuffed signal: the right padding must reach the last output's
    # taps, which the symmetric filter half alone does not for some
    # length/ratio pairs (dvc_tpu/ops/audio.py:86-91)
    stuffed_len = (t - 1) * up + 1
    pad_r = max(pad, (out_len - 1) * down + pad + 1 - stuffed_len)
    stuffed = x.new_zeros(x.shape[0], 1, pad + stuffed_len + pad_r)
    stuffed[..., pad:pad + stuffed_len:up] = x
    y = F.conv1d(stuffed, kernel.view(1, 1, -1), stride=down)
    return y.reshape(batch_shape + (-1,))[..., :out_len]


# --- volume ------------------------------------------------------------------

def normalize_volume(wav: torch.Tensor, target_dbfs: float = -30.0,
                     increase_only: bool = False, decrease_only: bool = False
                     ) -> torch.Tensor:
    """Match mean-power dBFS (reference preprocessing/encoder/audio.py:121-127)."""
    if increase_only and decrease_only:
        raise ValueError("Both increase_only and decrease_only are set")
    dbfs_change = target_dbfs - 10.0 * torch.log10(torch.mean(wav ** 2) + 1e-12)
    gain = torch.pow(10.0, dbfs_change / 20.0)
    if increase_only:
        gain = torch.clamp(gain, min=1.0)
    if decrease_only:
        gain = torch.clamp(gain, max=1.0)
    return wav * gain


def rescale_wav(wav: torch.Tensor, rescaling_max: float = 0.999) -> torch.Tensor:
    """Peak-normalize (reference preprocessing/hparams.py:72-76)."""
    return wav / torch.clamp(wav.abs().max(), min=1e-8) * rescaling_max


# --- VAD ---------------------------------------------------------------------

def _moving_average(x: torch.Tensor, width: int) -> torch.Tensor:
    """Same asymmetric zero-padded moving average as encoder/audio.py:105-109."""
    padded = F.pad(x, ((width - 1) // 2, width // 2))
    csum = F.pad(torch.cumsum(padded, 0), (1, 0))
    return (csum[width:] - csum[:-width]) / width


def _binary_dilation(mask: torch.Tensor, width: int) -> torch.Tensor:
    """scipy.ndimage.binary_dilation with a ones(width) structuring element."""
    pad = (width - 1) // 2
    m = F.pad(mask.to(torch.float32).view(1, 1, -1), (pad, width - 1 - pad))
    return F.max_pool1d(m, width, stride=1).view(-1) > 0


def _frames(wav: torch.Tensor, sample_rate: int, window_ms: int) -> torch.Tensor:
    spw = (window_ms * sample_rate) // 1000
    t = (wav.shape[-1] // spw) * spw
    return wav[:t].reshape(-1, spw)


def _postprocess(flags: torch.Tensor, moving_average_width: int,
                 max_silence_length: int) -> torch.Tensor:
    """Smoothing, rounding (half to even, as jnp.round) and dilation
    (encoder/audio.py:104-116)."""
    smoothed = _moving_average(flags.to(torch.float32), moving_average_width)
    return _binary_dilation(torch.round(smoothed) > 0, max_silence_length + 1)


def energy_vad_mask(wav: torch.Tensor, sample_rate: int = 16_000,
                    window_ms: int = 30, threshold_db: float = -48.0,
                    moving_average_width: int = 8,
                    max_silence_length: int = 6) -> torch.Tensor:
    """Per-window voiced mask, (T // samples_per_window,) bool: windowed RMS
    energy against a threshold, then the reference's smoothing chain."""
    frames = _frames(wav.to(torch.float32), sample_rate, window_ms)
    rms_db = 10.0 * torch.log10(torch.mean(frames ** 2, dim=-1) + 1e-12)
    return _postprocess(rms_db > threshold_db, moving_average_width, max_silence_length)


_VAD_BANDS_HZ = ((80, 250), (250, 500), (500, 1000),
                 (1000, 2000), (2000, 3000), (3000, 4000))
_N_BANDS = len(_VAD_BANDS_HZ)
# per-channel weights of the combined log-likelihood ratio
_VAD_CHANNEL_W = np.array([0.25, 0.2, 0.2, 0.15, 0.1, 0.1], np.float32)
# aggressiveness modes 0..3 (webrtcvad.Vad(mode)): (total-LLR threshold,
# single-channel override threshold, hangover frames)
_VAD_MODES = ((0.6, 2.0, 8), (0.9, 2.6, 6), (1.2, 3.2, 5), (1.6, 4.0, 4))


def _vad_band_matrix(spw: int, sample_rate: int) -> np.ndarray:
    """(spw//2+1, 6) 0/1 matrix summing rFFT power bins into the six
    WebRTC sub-bands."""
    freqs = np.fft.rfftfreq(spw, 1.0 / sample_rate)
    m = np.zeros((len(freqs), _N_BANDS), np.float32)
    for b, (lo, hi) in enumerate(_VAD_BANDS_HZ):
        m[(freqs >= lo) & (freqs < hi), b] = 1.0
    return m


def vad_band_features(wav: torch.Tensor, sample_rate: int = 16_000,
                      window_ms: int = 30) -> torch.Tensor:
    """(frames, 6) per-band share of each window's power in dBFS, on the
    waveform's device."""
    frames = _frames(wav.to(torch.float32), sample_rate, window_ms)
    spw = frames.shape[-1]
    band_m = torch.from_numpy(_vad_band_matrix(spw, sample_rate)).to(wav.device)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    # Parseval: mean x^2 over the frame ~= 2/N^2 * sum |X_k|^2
    return 10.0 * torch.log10(2.0 * (power @ band_m) / spw ** 2 + 1e-12)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def gmm_flags(feats: torch.Tensor, mode: int = 3) -> torch.Tensor:
    """The detector's frame recurrence (dvc_tpu's scan step,
    dvc_tpu/ops/audio.py:221-262) over (frames, 6) host features ->
    (frames,) raw-or-hangover flags.  Float32 throughout; constants are
    rounded to float32 before they meet the state, as jax's weak types do."""
    t_total, t_local, hang_max = _VAD_MODES[mode]
    feats = feats.to("cpu", torch.float32)
    chan_w = torch.from_numpy(_VAD_CHANNEL_W)
    inv_sqrt2pi = _f32(1.0 / np.sqrt(2.0 * np.pi))
    tiny = _f32(1e-30)

    def mixture(x, mean, std):
        z = (x[:, None] - mean) / std
        comp = inv_sqrt2pi / std * torch.exp(-0.5 * z * z)  # equal 1/2 weights
        dens = 0.5 * comp.sum(1)
        resp = comp / (comp.sum(1, keepdim=True) + tiny)
        return dens, resp

    def tile(v):
        return torch.tensor(v, dtype=torch.float32)[None, :].repeat(_N_BANDS, 1)

    noise_mean, noise_std = tile([-72.0, -55.0]), tile([8.0, 8.0])
    speech_mean, speech_std = tile([-38.0, -22.0]), tile([9.0, 9.0])
    feat_min = torch.full((_N_BANDS,), 30.0)
    over_hang = 0
    lr, leak, rise, sep = _f32(0.02), _f32(0.003), _f32(0.08), _f32(6.0)
    flags = torch.zeros(feats.shape[0], dtype=torch.bool)
    for i, x in enumerate(feats):
        p_n, r_n = mixture(x, noise_mean, noise_std)
        p_s, r_s = mixture(x, speech_mean, speech_std)
        llr = torch.log((p_s + tiny) / (p_n + tiny))
        raw = bool((chan_w * llr).sum() > t_total) or bool((llr > t_local).any())
        # minimum statistics: the noise floor rises slowly, snaps down at once
        feat_min = torch.minimum(x, feat_min + rise)
        # noise model: adapts on non-speech frames, always leaks to the floor
        # (dvc_tpu adds a zero step where the branch is not taken)
        if not raw:
            noise_mean = noise_mean + lr * r_n * (x[:, None] - noise_mean)
        noise_mean = noise_mean + leak * (feat_min[:, None] - noise_mean)
        # speech model: adapts on speech frames where the evidence is positive
        if raw:
            lr_s = lr * (llr > 0.0)[:, None]
            speech_mean = speech_mean + lr_s * r_s * (x[:, None] - speech_mean)
        # the hypotheses stay separated: speech 6 dB above the band's noise
        speech_mean = torch.maximum(speech_mean, noise_mean.amax(1, keepdim=True) + sep)
        flags[i] = raw or over_hang > 0
        over_hang = hang_max if raw else max(over_hang - 1, 0)
    return flags


def gmm_vad_mask(wav: torch.Tensor, sample_rate: int = 16_000,
                 window_ms: int = 30, mode: int = 3,
                 moving_average_width: int = 8,
                 max_silence_length: int = 6) -> torch.Tensor:
    """Per-window voiced mask from the adaptive dual-GMM detector (role of
    webrtcvad.Vad(mode).is_speech at encoder/audio.py:95-101), with the
    reference's smoothing chain; a host bool tensor."""
    flags = gmm_flags(vad_band_features(wav, sample_rate, window_ms), mode)
    return _postprocess(flags, moving_average_width, max_silence_length)


def trim_long_silences(wav: np.ndarray, sample_rate: int = 16_000,
                       window_ms: int = 30, detector: str = "gmm",
                       device: str | torch.device = "cpu", **kw) -> np.ndarray:
    """Drop the windows the VAD marks silent (a host gather: the output's
    length depends on the data).  detector: "gmm" or "energy"; the
    detector's features run on ``device``."""
    spw = (window_ms * sample_rate) // 1000
    t = (len(wav) // spw) * spw
    wav = np.asarray(wav)[:t]
    detect = {"gmm": gmm_vad_mask, "energy": energy_vad_mask}[detector]
    mask = detect(torch.from_numpy(np.ascontiguousarray(wav)).to(device), sample_rate,
                  window_ms, **kw).cpu().numpy()
    return wav[np.repeat(mask, spw)]


# --- mu-law ------------------------------------------------------------------

def mulaw(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(mu * x.abs()) / torch.log1p(_f32(mu)).to(x.device)


def inv_mulaw(y: torch.Tensor, mu: int = 255) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(y.abs() * torch.log1p(_f32(mu)).to(y.device)) / mu

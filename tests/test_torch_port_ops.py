"""Port parity of the mel front end: dvc_tpu_torch.ops vs dvc_tpu.ops on the
same numpy inputs."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.config import AudioConfig as JaxAudioConfig
from dvc_tpu.ops import chunk as jchunk
from dvc_tpu.ops import mel as jmel
from dvc_tpu.ops import stft as jstft
from dvc_tpu_torch.config import AudioConfig
from dvc_tpu_torch.ops import chunk, mel, stft


@pytest.mark.parametrize("length", [4096, 5000, 257])  # hop-aligned, ragged, short
def test_melspectrogram_matches(length):
    wav = np.random.RandomState(length).randn(length).astype(np.float32) * 0.3
    want = np.asarray(jmel.melspectrogram(jnp.asarray(wav), JaxAudioConfig()))
    got = mel.melspectrogram(torch.from_numpy(wav), AudioConfig()).numpy()
    assert got.shape == want.shape == (80, stft.num_frames(length, 1024, 256))
    # float32 FFTs sum in different orders (pocketfft vs XLA's); values in [0, 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_melspectrogram_batched_matches():
    wav = np.random.RandomState(3).randn(2, 3000).astype(np.float32) * 0.3
    want = np.asarray(jmel.melspectrogram(jnp.asarray(wav), JaxAudioConfig()))
    got = mel.melspectrogram(torch.from_numpy(wav), AudioConfig()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_framing_and_filterbank_identical():
    for n in range(1, 2000, 37):
        assert stft.num_frames(n, 1024, 256) == jstft.num_frames(n, 1024, 256)
        assert stft.pad_lr(n, 1024, 256) == jstft.pad_lr(n, 1024, 256)
    np.testing.assert_array_equal(mel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(stft._window("sqrt_hann", 1024),
                                  jstft._window("sqrt_hann", 1024))


@pytest.mark.parametrize("t", [1, 40, 64, 128, 130])  # 64 and 128: all-zero last chunk
def test_chunk_unchunk_exact(t):
    m = np.random.RandomState(t).rand(80, t).astype(np.float32)
    want = np.asarray(jchunk.chunk_mel(jnp.asarray(m), 64))
    got = chunk.chunk_mel(torch.from_numpy(m), 64).numpy()
    assert got.shape == want.shape == (t // 64 + 1, 80, 64)
    assert chunk.num_chunks(t) == jchunk.num_chunks(t)
    np.testing.assert_array_equal(got, want)
    if t % 64 == 0:
        assert not got[-1].any()
    for total in (None, t):
        np.testing.assert_array_equal(
            chunk.unchunk_mel(torch.from_numpy(np.array(want)), total).numpy(),
            np.asarray(jchunk.unchunk_mel(jnp.asarray(want), total)))

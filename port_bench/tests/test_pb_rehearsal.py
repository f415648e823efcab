"""Tiny-width rehearsals on the CPU: each traffic driver end to end against
the port's CPU path, and each reference module against the port's own
functions on the same inputs."""

import numpy as np
import pytest
import torch

from port_bench import common, corpus
from port_bench.drivers import http_convert, train_epochs
from port_bench.reference import audio as ref_audio
from port_bench.reference import vae as ref_vae
from port_bench.reference import wavenet as ref_wn
from port_bench.tests import tiny
from port_bench.weights import vae_shapes, vae_state_dict, vocoder_shapes, vocoder_state_dict


def checks(out):
    return {c.name: c.value for c in out.checks}


@pytest.mark.parametrize("clients", [1, 2])
def test_http_convert_rehearsal(clients):
    out = http_convert.run(tiny.serve_ctx(clients=clients))
    c = checks(out)
    assert out.attempted >= 1 and out.failed == 0
    assert c["failed_requests"] == 0 and c["reply_mismatch"] == 0
    assert c["mel_err"] < 1e-5 and c["draw_ratio"] < 1e-3
    assert all(x.ok for x in out.checks)
    e2e = out.end_to_end
    assert e2e["audio_s_per_s"] > 0 and e2e["latency_p95_s"] > 0 and e2e["setup_s"] > 0
    spans = [s for s in out.records["spans"] if s["name"] == "vocoder.batch"]
    assert spans and all(s["t1"] >= s["t0"] and s["rows"] >= 1 for s in spans)
    assert out.records["counters"]["requests"] == out.attempted


@pytest.mark.parametrize("cell", ["train-mel80-b256", "train-mcc36-b256"])
def test_train_epochs_rehearsal(cell):
    out = train_epochs.run(tiny.train_ctx(cell))
    c = checks(out)
    assert out.attempted >= 1
    assert c["loss_gap"] < 1e-5 and c["grad_gap"] < 1e-3 and c["change_gap"] < 1e-3
    assert c["batch_rows_off"] == 0
    assert all(x.ok for x in out.checks)
    assert out.end_to_end["train_frames_per_s"] > 0


def test_state_dict_shapes_are_the_programs():
    from dvc_tpu_torch.config import VAEConfig, VocoderConfig
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.models.wavenet import WaveNet
    cfg = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")
    with torch.device("meta"):
        vae = DisentangledVAE(VAEConfig(**cfg["vae"]), pair_fused=True)
        voc = WaveNet(VocoderConfig(**dict(cfg["vocoder"],
                                           upsample_scales=tuple(cfg["vocoder"]["upsample_scales"]))))
    assert {n: tuple(t.shape) for n, t in vae.state_dict().items()} == \
        {n: s for n, s, _ in vae_shapes(cfg["vae"])}
    assert {n: tuple(t.shape) for n, t in voc.state_dict().items()} == \
        {n: s for n, s, _ in vocoder_shapes(cfg["vocoder"])}


def test_reference_front_end_is_the_ports():
    from dvc_tpu_torch.config import AudioConfig
    from dvc_tpu_torch.ops.audio import resample_poly
    from dvc_tpu_torch.ops.mel import melspectrogram
    from dvc_tpu_torch.ops.stft import num_frames
    audio = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")["audio"]
    wav = corpus.speech([int(0.7 * 48000)], 48000, 3, "cpu")[0]
    x = resample_poly(wav, 48000, 16000)
    n = x.shape[-1]
    b = 1 << (n - 1).bit_length()
    want = melspectrogram(torch.nn.functional.pad(x, (0, b - n)), AudioConfig(**audio))
    want = want[:, :num_frames(n, 1024, 256)]
    got = ref_audio.front_end(wav.numpy(), 48000, audio, "cpu")
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-5


def test_reference_vae_is_the_ports():
    from dvc_tpu_torch.config import VAEConfig
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    cfg = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")
    vae = dict(cfg["vae"], **tiny.TINY_VAE)
    sd = vae_state_dict(vae, 5, "cpu")
    prog = DisentangledVAE(VAEConfig(**vae), pair_fused=True)
    prog.load_state_dict(sd)
    ref = ref_vae.on_device(vae, sd, "cpu")
    x = torch.rand(3, 80, 64)
    with torch.no_grad():
        prog.eval()
        want = prog.encode(x)
        got = ref_vae.encode(ref, x)
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() < 1e-5
        z = torch.randn(3, vae["latent_dim"])
        assert (ref_vae.decode(ref, z) - prog.decode(z)).abs().max().item() < 1e-5


def test_reference_draws_are_the_ports_cpu_path():
    from dvc_tpu_torch.config import VocoderConfig
    from dvc_tpu_torch.kernels.wavenet_step import generate
    from dvc_tpu_torch.models.wavenet import WaveNet
    cfg = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")
    voc = dict(cfg["vocoder"], **tiny.TINY_VOC)
    sd = vocoder_state_dict(voc, 9, "cpu")
    model = WaveNet(VocoderConfig(**dict(voc, upsample_scales=tuple(voc["upsample_scales"]))))
    model.load_state_dict(sd)
    frames = torch.rand(2, 3, 80)
    out = generate(model.eval(), frames, seed=77, weight_dtype=torch.float32, device="cpu")
    cond = ref_wn.upsample(sd, voc, frames)
    gum, u = ref_wn.cpu_stream_uniforms(77, 2, out.shape[1], voc["out_channels"] // 3)
    for row in range(2):
        y = ref_wn.teacher_forced(sd, voc, cond[row], out[row], "float32")
        e = ref_wn.judge_draws(y, out[row], gum[:, row], u[:, row], voc["log_scale_min"])
        assert e.max() < 1e-5
        assert np.abs(out[row].numpy()).max() < 1.0  # the head draws spread, not clip


def test_philox_known_answer():
    # Random123's published known-answer vector for philox4x32-10 with
    # counter = key = 0 (kat_vectors: 6627e8d5 e169c58d bc57ac4c 9b00dbd8)
    words = ref_wn.philox4x32_10(0, 0, 0, 0, 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]

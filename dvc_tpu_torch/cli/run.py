"""CLI of the port: preprocess / train / train-fs / convert / eval-mcd / serve
/ vocode / train-vocoder / train-speaker / embed / eval-eer / train-autovc /
preprocess-world / convert-world.

Same flags and defaults as dvc_tpu's commands (dvc_tpu/cli/run.py), plus
``--device {cuda,cpu}`` (default cuda; cuda without a card is an error).
The vocoder is Griffin-Lim by default (``--gl_iters``, 32); a bare
``--vocoder_ckpt`` selects the WaveNet vocoder (its sampler is the CUDA
kernel on cuda); ``--vocoder istft --vocoder_ckpt`` the iSTFT vocoder;
``--vocoder none`` returns mels.  ``--profile_transfer`` converts or serves
with the model-free DSP route.  ``train-vocoder`` trains the WaveNet (or,
with ``--arch istft``, the iSTFT vocoder) on a directory of wavs.
``train --adv_cof`` adds the adversarial content regularizer
(``--adv_mode confusion|grl``); ``train-fs`` trains the FeatureSelection
mask that ``--fs_mask`` reads; ``convert --long_context`` encodes whole
utterances, and ``convert --analyze`` writes the latent analysis.
``train-speaker`` trains the GE2E speaker encoder, ``embed`` and
``eval-eer`` use it, and ``train-autovc`` trains the AutoVC baseline (on a
GE2E encoder's embeddings with ``--encoder_run_id``).  The WORLD route:
``preprocess-world`` (``--f0 native|device``) writes WORLD features,
``train --features mcc`` trains the MCC-VAE on them, ``convert-world``
(``--synth native|device``) converts, ``serve --pipeline world`` serves,
and ``eval-mcd --analysis device`` scores with the batched device analysis.
Orbax checkpoints are not ported yet and exit with a message.

Usage (the verify recipe, then serving):
  python -m dvc_tpu_torch.cli.run preprocess <datasets_root> -o <mel_dir> -d VCTK [--no_trim]
  python -m dvc_tpu_torch.cli.run train --dataset_fp <mel_dir> --log_dir <run> [--adv_cof 1]
  python -m dvc_tpu_torch.cli.run convert --dataset_fp <mel_dir> --log_dir <run> \\
      --src_spk A --trg_spk B [--long_context] [--analyze]
  python -m dvc_tpu_torch.cli.run train-fs --dataset_fp <mel_dir> --log_dir <run>
  python -m dvc_tpu_torch.cli.run convert ... --fs_mask <run>/feature_mask.npz --analyze
  python -m dvc_tpu_torch.cli.run eval-mcd --src_dir <wavs> --cvt_dir <wavs>
  python -m dvc_tpu_torch.cli.run serve --dataset_fp <mel_dir> --log_dir <run>
  python -m dvc_tpu_torch.cli.run serve --dataset_fp <mel_dir> --profile_transfer
  python -m dvc_tpu_torch.cli.run vocode <mel.npy> [--vocoder_ckpt <r9y9 .pth | .msgpack>]
  python -m dvc_tpu_torch.cli.run train-vocoder <wav_dir> -m <models_dir> [--arch istft]
  python -m dvc_tpu_torch.cli.run convert ... --vocoder istft --vocoder_ckpt <istft .msgpack>
  python -m dvc_tpu_torch.cli.run train-speaker <run_id> <mel_root> -m <models_dir>
  python -m dvc_tpu_torch.cli.run embed <run_id> <wav_dir> -m <models_dir> -o <out_dir>
  python -m dvc_tpu_torch.cli.run eval-eer <run_id> <mel_root> -m <models_dir>
  python -m dvc_tpu_torch.cli.run train-autovc --dataset_fp <mel_dir> --log_dir <run> \\
      [--encoder_run_id <run_id> -m <models_dir>]
  python -m dvc_tpu_torch.cli.run preprocess-world <wav_root> -o <world_dir> [--f0 device]
  python -m dvc_tpu_torch.cli.run train --features mcc --dataset_fp <world_dir> --log_dir <run>
  python -m dvc_tpu_torch.cli.run convert-world --dataset_fp <world_dir> --log_dir <run> \\
      --src_spk A --trg_spk B [--synth device] [--fs_mask <feature_mask.npz>]
  python -m dvc_tpu_torch.cli.run serve --pipeline world --dataset_fp <world_dir> --log_dir <run>
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

NOT_PORTED = "not yet ported — see ROADMAP.md"


def _add_model_args(p: argparse.ArgumentParser) -> None:
    """dvc_tpu's _add_train_args: ``train`` reads them all; the serving
    commands read the model geometry and accept the rest unused."""
    p.add_argument("--dataset_fp", required=True)
    p.add_argument("--log_dir", default="./results")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=200_000)
    p.add_argument("--latent-size", type=int, default=32)
    p.add_argument("--speaker_size", type=int, default=4)
    p.add_argument("--samples_length", type=int, default=None)
    p.add_argument("--report-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mse_cof", type=float, default=10.0)
    p.add_argument("--kl_cof", type=float, default=10.0)
    p.add_argument("--style_cof", type=float, default=0.1)
    p.add_argument("--beta_cof", type=float, default=0.1)
    p.add_argument("--adv_cof", type=float, default=0.0)
    p.add_argument("--adv_lr", type=float, default=1e-3)
    p.add_argument("--adv_mode", default="confusion", choices=["confusion", "grl"])
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="bfloat16 rounds the training inputs to bf16 and computes "
                        "in float32, as dvc_tpu does; serving is float32")
    p.add_argument("--checkpoint-format", default="msgpack", choices=["msgpack", "orbax"],
                   help="msgpack: dvc_tpu's TrainState .msgpack; orbax: its .orbax "
                        "directory (under torchrun each rank writes its own shards); "
                        "a one-process save also writes the reference's .pth state "
                        "dict and an .opt.pth beside it")
    p.add_argument("--features", default="mel", choices=["mel", "mcc"])
    p.add_argument("--num_mcep", type=int, default=36)
    p.add_argument("--do-not-resume", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def _add_fs_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fs_mask", default="",
                   help="feature_mask.npz from train-fs (or a bare .npy mask): "
                        "FeatureSelection-masked latent swap")
    p.add_argument("--fs_threshold", type=float, default=0.5)
    p.add_argument("--fs_top_k", type=int, default=None)


def _add_vocoder_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--vocoder_ckpt", default="",
                   help="WaveNet checkpoint (r9y9 .pth or dvc_tpu's .msgpack), "
                        "which overrides the griffinlim default; with --vocoder "
                        "istft, the iSTFT vocoder's .msgpack")
    p.add_argument("--vocoder", default="griffinlim",
                   choices=["none", "griffinlim", "istft"])
    p.add_argument("--gl_iters", type=int, default=32)


def _config_from_args(args):
    from dvc_tpu_torch.config import Config, LossConfig, TrainConfig, VAEConfig
    mcc = args.features == "mcc"
    if args.samples_length is None:
        # the reference's crops: 64 mel frames (train.py:53), 128 MCC frames
        # (SpeechDatasetMCC2), so train and convert-world agree unasked
        args.samples_length = 128 if mcc else 64
    vae = VAEConfig(latent_dim=args.latent_size, speaker_size=args.speaker_size,
                    frames=args.samples_length, num_mels=args.num_mcep if mcc else 80)
    loss = LossConfig(mse_cof=args.mse_cof, kl_cof=args.kl_cof, style_cof=args.style_cof,
                      beta_cof=args.beta_cof, adv_cof=args.adv_cof, adv_lr=args.adv_lr,
                      adv_mode=args.adv_mode)
    train = TrainConfig(batch_size=args.batch_size, learning_rate=args.lr,
                        epochs=args.epochs, report_interval=args.report_interval,
                        seed=args.seed, samples_length=args.samples_length,
                        compute_dtype=args.compute_dtype,
                        checkpoint_format=args.checkpoint_format)
    return Config(vae=vae, loss=loss, train=train)


def _load_model(args, cfg):
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.train.checkpoint import load_last_checkpoint
    model = DisentangledVAE(cfg.vae)
    epoch = load_last_checkpoint(os.path.join(args.log_dir, "checkpoints"), model)
    print(f"loaded checkpoint at epoch {epoch}")
    return model


def _make_cli_vocoder(args, cfg):
    """--vocoder istft needs --vocoder_ckpt; a bare --vocoder_ckpt is the
    WaveNet; griffinlim is the checkpoint-free default; none disables
    waveform output."""
    if args.vocoder == "istft":
        if not args.vocoder_ckpt:
            raise SystemExit("--vocoder istft needs --vocoder_ckpt")
        from dvc_tpu_torch.convert.vocode import make_istft_vocoder
        return make_istft_vocoder(args.vocoder_ckpt, audio=cfg.audio, device=args.device)
    if args.vocoder_ckpt:
        from dvc_tpu_torch.convert.vocode import make_vocoder
        return make_vocoder(args.vocoder_ckpt, seed=0, device=args.device)
    if args.vocoder == "griffinlim":
        from dvc_tpu_torch.convert.griffinlim import make_griffinlim_vocoder
        return make_griffinlim_vocoder(cfg.audio, n_iter=args.gl_iters, device=args.device)
    return None


def _load_fs_mask(args, cfg):
    """--fs_mask feature_mask.npz -> (raw sigmoid mask, binary swap mask), or
    (None, None) without the flag."""
    if not args.fs_mask:
        return None, None
    import numpy as np

    from dvc_tpu_torch.convert.conversion import binarize_fs_mask
    loaded = np.load(args.fs_mask)
    raw = loaded["mask"] if hasattr(loaded, "files") else loaded
    if raw.shape != (cfg.vae.latent_dim,):
        raise SystemExit(f"--fs_mask shape {raw.shape} != latent_dim "
                         f"({cfg.vae.latent_dim},) — was train-fs run on this model?")
    fs_mask = binarize_fs_mask(raw, cfg.vae.speaker_size, args.fs_threshold,
                               top_k=args.fs_top_k)
    print(f"FS-masked swap: {int(fs_mask.sum())}/{len(fs_mask)} dims "
          f"{np.where(fs_mask > 0)[0].tolist()}")
    return raw, fs_mask


def cmd_preprocess(args) -> int:
    from dvc_tpu_torch.data.preprocess import preprocess_dataset
    stats = preprocess_dataset(args.datasets_root, args.out_dir, args.dataset,
                               skip_existing=args.skip_existing, trim=not args.no_trim,
                               device=args.device)
    print(f"preprocessed {stats.n_files} files ({stats.n_frames} mel frames), "
          f"skipped {stats.n_skipped}")
    return 0


_JOINED = []  # the process group _join_ranks created, which main leaves at the end


def _join_ranks(args) -> bool:
    """Join torchrun's process group, if the environment has one (a no-op
    without it); returns whether this process writes the run's files."""
    from dvc_tpu_torch.parallel.mesh import has_process_group
    from dvc_tpu_torch.parallel.multihost import initialize_distributed, is_primary
    had = has_process_group()
    initialize_distributed(device=args.device)
    if not had and has_process_group():
        _JOINED.append(True)
    return is_primary()


def _leave_ranks() -> None:
    if _JOINED:
        import torch.distributed as dist
        _JOINED.clear()
        dist.destroy_process_group()


def _quiet(*_args) -> None:
    pass


def cmd_train(args) -> int:
    from dvc_tpu_torch.data.dataset import PairedMCCDataset, PairedMelDataset
    from dvc_tpu_torch.train.trainer import Trainer, unported_settings
    primary = _join_ranks(args)
    cfg = _config_from_args(args)
    bad = unported_settings(cfg)
    if bad:
        raise SystemExit(f"{', '.join(bad)}: {NOT_PORTED}")
    ds_cls = PairedMCCDataset if args.features == "mcc" else PairedMelDataset
    dataset = ds_cls(args.dataset_fp, samples_length=args.samples_length, seed=args.seed)
    if cfg.loss.adv_cof > 0:
        # the adversary's classifier is as wide as the corpus has speakers
        cfg = cfg.replace(loss=dataclasses.replace(
            cfg.loss, adv_speakers=len(dataset.speaker_ids)))
    if primary:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    trainer = Trainer(cfg, checkpoints_path=os.path.join(args.log_dir, "checkpoints"),
                      logs_path=os.path.join(args.log_dir, "logs"),
                      estimation_dir=os.path.join(args.log_dir, "images", "estimation"),
                      device=args.device)
    try:
        trainer.run_training(dataset, args.epochs, report_interval=args.report_interval,
                             reload_model=not args.do_not_resume,
                             logging_func=print if primary else _quiet)
    finally:
        trainer.close()
    return 0


def _serve_forever(server, what: str) -> None:
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} ({what})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def cmd_serve(args) -> int:
    from dvc_tpu_torch.serve import (ConversionService, ProfileTransferService,
                                     WorldConversionService, make_http_server)
    if args.pipeline == "world":
        if args.profile_transfer:
            raise SystemExit("--profile_transfer serves the mel pipeline only; "
                             "drop --pipeline world")
        # the WORLD route serves the MCC-VAE; dataset_fp is a
        # preprocess-world directory
        args.features = "mcc"
    cfg = _config_from_args(args)
    if args.profile_transfer:
        # the model-free DSP route: no checkpoint; the vocoder is the only
        # device work
        if args.fs_mask:
            raise SystemExit("--profile_transfer is model-free; --fs_mask does not apply")
        service = ProfileTransferService(cfg, args.dataset_fp, _make_cli_vocoder(args, cfg),
                                         max_wait_ms=args.max_wait_ms, device=args.device)
        _serve_forever(make_http_server(service, args.host, args.port),
                       f"{len(service.speakers())} target speakers, profile-transfer "
                       f"DSP route, device {args.device}")
        return 0
    if args.pipeline == "world":
        _, fs_mask = _load_fs_mask(args, cfg)
        service = WorldConversionService(cfg, _load_model(args, cfg), args.dataset_fp,
                                         sample_rate=cfg.audio.sample_rate,
                                         max_wait_ms=args.max_wait_ms, fs_mask=fs_mask,
                                         device=args.device)
        _serve_forever(make_http_server(service, args.host, args.port),
                       f"{len(service.speakers())} target speakers, WORLD pipeline, "
                       f"device {args.device}")
        return 0
    vocoder = _make_cli_vocoder(args, cfg)  # a bad vocoder choice exits before any load
    _, fs_mask = _load_fs_mask(args, cfg)
    service = ConversionService(cfg, _load_model(args, cfg), args.dataset_fp, vocoder,
                                max_wait_ms=args.max_wait_ms, fs_mask=fs_mask,
                                device=args.device)
    _serve_forever(make_http_server(service, args.host, args.port),
                   f"{len(service.speakers())} target speakers, device {args.device}")
    return 0


def cmd_convert(args) -> int:
    from dvc_tpu_torch.convert.conversion import VoiceConverter
    from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32
    cfg = _config_from_args(args)
    device = resolve_device(args.device)
    model = None
    if args.profile_transfer:
        if args.fs_mask:
            raise SystemExit("--profile_transfer is model-free; --fs_mask does not apply")
        if args.analyze:
            raise SystemExit("--analyze needs a trained model; drop it or "
                             "drop --profile_transfer")
    else:
        use_exact_float32()  # the VAE is served in float32, never TF32
    vocoder = _make_cli_vocoder(args, cfg)  # a bad vocoder choice exits before any load
    if not args.profile_transfer:
        model = _load_model(args, cfg).to(device).eval()
    raw, fs_mask = _load_fs_mask(args, cfg)
    converter = VoiceConverter(cfg, model, seed=args.seed, long_context=args.long_context,
                               fs_mask=fs_mask, profile_transfer=args.profile_transfer)
    gen_dir = os.path.join(args.log_dir, "generation")
    results = converter.convert_speaker_pair(
        args.dataset_fp, args.src_spk, args.trg_spk, gen_dir,
        num_utterances=args.num_utterances, vocoder=vocoder)
    print(f"converted {len(results)} utterances {args.src_spk} -> {args.trg_spk}")
    if args.analyze:
        _analyze(args, cfg, model, gen_dir, raw, fs_mask)
    return 0


def _analyze(args, cfg, model, gen_dir, raw, fs_mask) -> None:
    """The latent-analysis artifacts (dvc_tpu/cli/run.py:204-242; reference
    model/plot.py:23-55): per speaker directory, the mean and population std
    of [style_mu, content_mu] over the chunks of up to 16 sorted
    utterances, as latent_analysis.png and .npz; with --fs_mask, the mask as
    fs_mask.png and fs_mask.npz (sigmoid_mask, binary_mask)."""
    from glob import glob

    import numpy as np
    import torch

    from dvc_tpu_torch.ops.chunk import chunk_mel
    from dvc_tpu_torch.utils.plotting import plot_fs_mask, plot_latent_analysis
    dev = next(model.parameters()).device
    mus, stds, spk_ids = [], [], []
    for spk_dir in sorted(glob(os.path.join(args.dataset_fp, "*"))):
        fps = sorted(glob(os.path.join(spk_dir, "*.npy")))[:16]
        if not os.path.isdir(spk_dir) or not fps:
            continue
        chunks = torch.cat([chunk_mel(torch.from_numpy(np.load(fp).astype(np.float32)).to(dev),
                                      cfg.vae.frames) for fp in fps])
        with torch.inference_mode():
            smu, _, cmu, _ = model.encode(chunks)
        lat = torch.cat([smu, cmu], -1).cpu().numpy()
        mus.append(lat.mean(0))
        stds.append(lat.std(0))
        spk_ids.append(os.path.basename(spk_dir))
    os.makedirs(gen_dir, exist_ok=True)
    plot_latent_analysis(np.stack(mus), np.stack(stds), spk_ids,
                         os.path.join(gen_dir, "latent_analysis.png"),
                         os.path.join(gen_dir, "latent_analysis.npz"))
    if fs_mask is not None:
        plot_fs_mask(raw, os.path.join(gen_dir, "fs_mask.png"), args.fs_threshold,
                     cfg.vae.speaker_size)
        np.savez(os.path.join(gen_dir, "fs_mask.npz"), sigmoid_mask=raw, binary_mask=fs_mask)
    print(f"latent analysis artifacts -> {gen_dir}")


def cmd_preprocess_world(args) -> int:
    """WORLD features of every speaker directory under dataset_fp
    (dvc_tpu's preprocess-world)."""
    from dvc_tpu_torch.data.world_preprocess import preprocess_world_dataset
    for s in preprocess_world_dataset(args.dataset_fp, args.out_dir, num_mcep=args.num_mcep,
                                      f0_mode=args.f0, device=args.device):
        if s["n_files"] == 0:
            print(f"{s['speaker']}: no wavs, skipped")
            continue
        print(f"{s['speaker']}: {s['n_files']} files, "
              f"logf0 {s['logf0_mean']:.3f}±{s['logf0_std']:.3f}")
    return 0


def cmd_convert_world(args) -> int:
    """WORLD-feature conversion (dvc_tpu's convert-world,
    dvc_tpu/cli/run.py:566-625): the latent swap on normalized MCCs, the
    log-Gaussian pitch transform and WORLD synthesis, natively per
    utterance or (--synth device) batched on the device.  Writes
    <log_dir>/generation_world/<src>_to_<trg>/convert_<src>_to_<trg>_<utt>.wav."""
    from glob import glob

    import numpy as np

    from dvc_tpu_torch.convert.world_conversion import (world_convert_corpus,
                                                        world_convert_utterance)
    from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32
    from dvc_tpu_torch.utils.wavio import write_wav
    args.features = "mcc"
    cfg = _config_from_args(args)
    use_exact_float32()  # the VAE in float32, never TF32
    model = _load_model(args, cfg).to(resolve_device(args.device)).eval()

    def load(path):
        with np.load(path) as z:
            return dict(z)

    trg_stats = load(os.path.join(args.dataset_fp, f"mcep_{args.trg_spk}.npz"))
    src_logf0 = load(os.path.join(args.dataset_fp, f"log_f0_{args.src_spk}.npz"))
    trg_logf0 = load(os.path.join(args.dataset_fp, f"log_f0_{args.trg_spk}.npz"))
    src_fps = sorted(glob(os.path.join(args.dataset_fp, args.src_spk, "*.npz")))
    # sorted, so --seed picks the same target utterance on any filesystem
    trg_fps = sorted(glob(os.path.join(args.dataset_fp, args.trg_spk, "*.npz")))
    rng = np.random.RandomState(args.seed)
    out_dir = os.path.join(args.log_dir, "generation_world", f"{args.src_spk}_to_{args.trg_spk}")
    os.makedirs(out_dir, exist_ok=True)
    n = min(args.num_utterances, len(src_fps))
    src_npzs = [load(src_fps[i]) for i in range(n)]
    trg_npzs = [load(trg_fps[rng.choice(len(trg_fps))]) for _ in range(n)]
    src_lf0 = {"mean": float(src_logf0["mean"]), "std": float(src_logf0["std"])}
    trg_lf0 = {"mean": float(trg_logf0["mean"]), "std": float(trg_logf0["std"])}
    _, fs_mask = _load_fs_mask(args, cfg)
    if args.synth == "device":
        wavs = world_convert_corpus(model, src_npzs, trg_npzs, trg_stats, src_lf0, trg_lf0,
                                    frames=args.samples_length, fs_mask=fs_mask)
    else:
        wavs = [world_convert_utterance(model, s, t, trg_stats, src_lf0, trg_lf0,
                                        frames=args.samples_length, fs_mask=fs_mask)
                for s, t in zip(src_npzs, trg_npzs)]
    for i, wav in enumerate(wavs):
        utt = os.path.splitext(os.path.basename(src_fps[i]))[0]
        out = os.path.join(out_dir, f"convert_{args.src_spk}_to_{args.trg_spk}_{utt}.wav")
        write_wav(out, wav, 16_000)
        print(f"wrote {out}")
    return 0


def cmd_train_fs(args) -> int:
    """Feature-selection training on the frozen VAE's latents (dvc_tpu's
    train-fs, dvc_tpu/cli/run.py:490-524): encode the corpus in unshuffled
    batches, train, write <log_dir>/feature_mask.npz (mask, acc)."""
    import numpy as np

    from dvc_tpu_torch.data.dataset import PairedMelDataset
    from dvc_tpu_torch.train.feature_selection_trainer import FeatureSelectionTrainer
    from dvc_tpu_torch.train.trainer import Trainer
    cfg = _config_from_args(args)
    trainer = Trainer(cfg, checkpoints_path=os.path.join(args.log_dir, "checkpoints"),
                      device=args.device)
    epoch = trainer.load_last()
    print(f"loaded VAE checkpoint at epoch {epoch - 1}")
    ds = PairedMelDataset(args.dataset_fp, samples_length=args.samples_length)
    fs_trainer = FeatureSelectionTrainer(cfg.vae.latent_dim, num_spk=len(ds.speaker_ids),
                                         device=args.device)
    latents, labels = [], []
    for x1, _x2, spk in ds.batches(min(cfg.train.batch_size, max(1, len(ds))),
                                   shuffle=False):
        latents.append(fs_trainer.encode_latents(trainer.model, x1))
        labels.append(spk)
    latents = np.concatenate(latents)
    last = fs_trainer.train(latents, np.concatenate(labels), epochs=args.fs_epochs)
    mask = fs_trainer.feature_mask(latents)
    out = os.path.join(args.log_dir, "feature_mask.npz")
    np.savez(out, mask=mask, acc=last.get("acc", 0.0))
    print(f"speaker-discriminative dims (mask>0.5): "
          f"{np.where(mask > 0.5)[0].tolist()} -> {out}")
    return 0


def cmd_vocode(args) -> int:
    import numpy as np

    from dvc_tpu_torch.config import AudioConfig
    from dvc_tpu_torch.utils.wavio import write_wav
    mel = np.load(args.mel_npy)
    if mel.ndim != 2:
        raise SystemExit(f"expected an (n_mels, T) mel, got {mel.shape}")
    if args.vocoder_ckpt:
        from dvc_tpu_torch.convert.vocode import make_vocoder
        voc = make_vocoder(args.vocoder_ckpt, device=args.device)
    else:
        from dvc_tpu_torch.convert.griffinlim import make_griffinlim_vocoder
        voc = make_griffinlim_vocoder(AudioConfig(), n_iter=args.gl_iters,
                                      device=args.device)
    wav = voc(mel)
    out = args.out or os.path.splitext(args.mel_npy)[0] + "_vocoded.wav"
    write_wav(out, wav, 16_000)
    print(f"wrote {out} ({len(wav) / 16_000:.2f}s)")
    return 0


def cmd_train_vocoder(args) -> int:
    """Vocoder training on a directory of wavs: --arch wavenet (the
    default) trains the reference recipe's AR WaveNet and saves its EMA
    trail; --arch istft trains the non-autoregressive iSTFT vocoder."""
    if args.arch == "istft":
        from dvc_tpu_torch.train.istft_vocoder_trainer import (ISTFTVocoderTrainer,
                                                               mel_wav_batches)
        trainer = ISTFTVocoderTrainer(lr=args.lr, seed=args.seed, device=args.device)
        crop_frames = max(8, args.max_time_steps // trainer.audio.hop_size)
        batches = mel_wav_batches(args.wav_dir, args.batch_size, crop_frames, seed=args.seed)
        trainer.train_steps(batches, args.n_steps)
        run_id = "istft_voc" if args.run_id == "wavenet" else args.run_id
        path = trainer.save(args.models_dir, run_id=run_id)
        print(f"saved istft vocoder checkpoint -> {path}")
        return 0

    from dvc_tpu_torch.config import VocoderConfig
    from dvc_tpu_torch.train.vocoder_trainer import VocoderTrainer, wav_batches
    cfg = VocoderConfig(layers=args.layers, stacks=args.stacks,
                        residual_channels=args.residual_channels,
                        gate_channels=args.residual_channels,
                        skip_out_channels=max(8, args.residual_channels // 2))
    trainer = VocoderTrainer(cfg, lr=args.lr, device=args.device)
    batches = wav_batches(args.wav_dir, args.batch_size, args.max_time_steps, cfg,
                          seed=args.seed)
    trainer.train_steps(batches, args.n_steps)
    path = trainer.save(args.models_dir, run_id=args.run_id)
    print(f"saved vocoder (EMA) checkpoint -> {path}")
    return 0


def _load_embedder(run_id: str, models_dir: str, device: str):
    """A SpeakerEmbedder on ``device`` with the weights of the GE2E run
    ``run_id`` (either package's ``{run_id}.msgpack``) at the full
    SpeakerEncoderConfig; exits with dvc_tpu's message when there is none."""
    from dvc_tpu_torch.config import SpeakerEncoderConfig
    from dvc_tpu_torch.models.speaker_inference import SpeakerEmbedder
    from dvc_tpu_torch.train.speaker_trainer import SpeakerEncoderTrainer
    cfg = SpeakerEncoderConfig()
    trainer = SpeakerEncoderTrainer(cfg, run_id=run_id, models_dir=models_dir, device=device)
    if not trainer.resume():
        raise SystemExit(f"no {run_id} checkpoint in {models_dir}")
    embedder = SpeakerEmbedder(cfg, device=device)
    embedder.load(trainer.model.state_dict())
    return embedder


def _center_crop(mel, win: int):
    """(T, n_mels) -> its centre ``win`` frames, zero-padded when shorter
    (dvc_tpu's crop in train-autovc and eval-eer)."""
    import numpy as np
    if len(mel) < win:
        mel = np.pad(mel, ((0, win - len(mel)), (0, 0)))
    start = max(0, (len(mel) - win) // 2)
    return mel[start:start + win]


def cmd_train_speaker(args) -> int:
    """GE2E speaker-encoder training (reference preprocessing/encoder/train.py:18-133)."""
    from dvc_tpu_torch.config import SpeakerEncoderConfig
    from dvc_tpu_torch.data.speaker_dataset import (DeviceResidentSampler,
                                                    SpeakerVerificationSampler)
    from dvc_tpu_torch.train.speaker_trainer import SpeakerEncoderTrainer
    from dvc_tpu_torch.utils.visualizations import Visualizations
    primary = _join_ranks(args)
    cfg = SpeakerEncoderConfig(speakers_per_batch=args.speakers_per_batch,
                               utterances_per_speaker=args.utterances_per_speaker,
                               learning_rate=args.lr)
    sampler = None
    if not args.no_resident_pool:
        # the utterance pool on the device: a step uploads its crop indices
        # (~5 KB) instead of the 12.9 MB batch
        try:
            sampler = DeviceResidentSampler(
                args.clean_data_root, cfg.speakers_per_batch, cfg.utterances_per_speaker,
                cfg.partials_n_frames, seed=args.seed, device=args.device)
            print(f"device-resident pool: {sampler.pool.shape[0]} utterances "
                  f"({sampler.pool.nbytes / 2**20:.0f} MB on device)")
        except MemoryError as e:
            print(f"resident pool disabled ({e}); streaming from host")
    if sampler is None:
        sampler = SpeakerVerificationSampler(
            args.clean_data_root, cfg.speakers_per_batch, cfg.utterances_per_speaker,
            cfg.partials_n_frames, seed=args.seed)
    trainer = SpeakerEncoderTrainer(cfg, run_id=args.run_id, models_dir=args.models_dir,
                                    device=args.device)
    log = print if primary else _quiet
    if not args.no_resume and trainer.resume():
        log(f"resumed {args.run_id} at step {trainer.step}")
    # live loss/EER/step-time curves + periodic embedding projections
    # (reference encoder/train.py:56-111 visdom/UMAP loop), rank 0's
    vis = None
    if primary:
        vis = Visualizations(args.run_id, os.path.join(args.models_dir, "viz"))
        vis.log_params(cfg)
        vis.log_dataset(args.clean_data_root, len(sampler.speakers))
    trainer.train(sampler, args.n_steps, save_every=args.save_every,
                  backup_every=args.backup_every, vis=vis, projection_every=args.umap_every,
                  logging_func=log)
    return 0


def cmd_embed(args) -> int:
    """Utterance embeddings from a trained GE2E encoder (reference
    preprocessing/encoder/inference.py:111-155 over a directory).  As in
    dvc_tpu, a wav is embedded at its own sample rate, without resampling
    (ROADMAP Queue 3)."""
    from glob import glob

    import numpy as np

    from dvc_tpu_torch.utils.wavio import read_audio
    embedder = _load_embedder(args.run_id, args.models_dir, args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    fps = sorted(glob(os.path.join(args.wav_dir, "**", "*.wav"), recursive=True)
                 + glob(os.path.join(args.wav_dir, "**", "*.flac"), recursive=True))
    for fp in fps:
        wav, _sr = read_audio(fp)
        embed = embedder.embed_utterance(wav)
        rel = os.path.relpath(fp, args.wav_dir)
        out_fn = "_".join(os.path.splitext(rel)[0].split(os.sep)) + "_embed.npy"
        np.save(os.path.join(args.out_dir, out_fn), embed)
    print(f"embedded {len(fps)} utterances -> {args.out_dir}")
    return 0


def cmd_eval_eer(args) -> int:
    """Verification EER of a trained GE2E encoder over a labeled mel dir (one
    subdirectory a speaker; dvc_tpu's eval-eer): one centre crop an
    utterance, up to --max_utts a speaker."""
    from glob import glob

    import numpy as np

    from dvc_tpu_torch.eval.eer import verification_eer
    embedder = _load_embedder(args.run_id, args.models_dir, args.device)
    win = embedder.cfg.partials_n_frames
    embeds, ids = [], []
    for spk in sorted(os.listdir(args.mel_dir)):
        d = os.path.join(args.mel_dir, spk)
        if not os.path.isdir(d):
            continue
        for fp in sorted(glob(os.path.join(d, "*.npy")))[:args.max_utts]:
            e = embedder.embed_frames_batch(_center_crop(np.load(fp).T, win)[None])[0]
            embeds.append(e / max(1e-12, np.linalg.norm(e)))
            ids.append(spk)
    if len(set(ids)) < 2:
        raise SystemExit("need at least two speakers with utterances")
    eer = verification_eer(np.stack(embeds), np.asarray(ids))
    print(f"verification EER over {len(ids)} utterances, "
          f"{len(set(ids))} speakers: {eer:.4f}")
    return 0


def cmd_train_autovc(args) -> int:
    """AutoVC baseline training (dvc_tpu's train-autovc): the reconstruction
    and content-consistency objective, conditioned on the speakers' mean
    GE2E embeddings (--encoder_run_id; up to 8 centre crops a speaker) or
    on one-hot codes.  Writes <log_dir>/autovc_{epoch}.msgpack (dvc_tpu's
    AutoVCState) every --report-interval epochs and at the last."""
    import numpy as np
    import torch

    from dvc_tpu_torch.config import AutoVCConfig
    from dvc_tpu_torch.data.dataset import PairedMelDataset
    from dvc_tpu_torch.train.autovc_trainer import (autovc_state_tree, create_autovc,
                                                    make_autovc_step)
    from dvc_tpu_torch.utils import msgpack
    if args.samples_length is None:
        args.samples_length = 64  # AutoVC trains on mel crops
    ds = PairedMelDataset(args.dataset_fp, samples_length=args.samples_length)
    acfg = AutoVCConfig()

    # the per-speaker conditioning table
    emb_table = np.zeros((len(ds.speaker_ids), acfg.dim_emb), np.float32)
    if args.encoder_run_id:
        embedder = _load_embedder(args.encoder_run_id, args.models_dir, args.device)
        win = embedder.cfg.partials_n_frames
        for si, utts in enumerate(ds.spk_utt):
            crops = np.stack([_center_crop(np.load(fp).T, win) for fp in utts[:8]])
            mean = embedder.embed_frames_batch(crops).mean(axis=0)
            emb_table[si] = mean / max(1e-8, np.linalg.norm(mean))
    else:
        # one-hot speaker codes, dvc_tpu's stand-in for a trained encoder
        for si in range(len(ds.speaker_ids)):
            emb_table[si, si % acfg.dim_emb] = 1.0

    model, optimizer = create_autovc(acfg, lr=args.lr, seed=args.seed, device=args.device)
    dev = next(model.parameters()).device
    step = make_autovc_step(model, optimizer)
    os.makedirs(args.log_dir, exist_ok=True)
    bs = min(args.batch_size, max(1, len(ds)))
    n_steps = 0
    for epoch in range(1, args.epochs + 1):
        total, n = torch.zeros((), dtype=torch.float64, device=dev), 0
        for x1, _x2, spk in ds.batches(bs):
            x = torch.from_numpy(np.ascontiguousarray(np.transpose(x1, (0, 2, 1)),
                                                      np.float32)).to(dev)
            emb = torch.from_numpy(emb_table[np.asarray(spk)]).to(dev)
            total += step(x, emb).total
            n += 1
        n_steps += n
        ds.shuffle_data()
        print(f"====> AutoVC epoch {epoch}: loss {total.item() / max(n, 1):.4f}")
        if epoch % args.report_interval == 0 or epoch == args.epochs:
            out = os.path.join(args.log_dir, f"autovc_{epoch}.msgpack")
            with open(out, "wb") as f:
                f.write(msgpack.packb(autovc_state_tree(model, optimizer, n_steps)))
    return 0


def _pair_converted_to_source(src_dir: str, cvt_dir: str) -> list:
    """Match converted wavs to their source wavs without renaming (dvc_tpu's
    rule, dvc_tpu/cli/run.py:525-563).

    Supports both naming conventions:
      * the converter's output (convert/conversion.py):
        <cvt_dir>/[<src>_to_<trg>/]convert_<src>_to_<trg>_<utt_id>.wav
        matched to a source wav whose stem ends with _<utt_id> (or equals it);
      * the reference's MCD_calculate.py:72 convention: <utt>_cv.wav
        matched to <src_dir>/<utt>.wav.
    Returns [(src_fp, cvt_fp), ...] sorted by converted path.
    """
    import re
    from glob import glob

    src_fps = sorted(glob(os.path.join(src_dir, "**", "*.wav"), recursive=True))
    by_stem = {os.path.splitext(os.path.basename(fp))[0]: fp for fp in src_fps}
    stems_sorted = sorted(by_stem.items())

    pairs = []
    for fp in sorted(glob(os.path.join(cvt_dir, "**", "*.wav"), recursive=True)):
        stem = os.path.splitext(os.path.basename(fp))[0]
        m = re.match(r"convert_(?P<src>.+)_to_(?P<trg>.+?)_(?P<utt>[^_]+)$", stem)
        if m:
            src_spk, utt_id = m.group("src"), m.group("utt")
            # prefer the exact "<src_spk>_<utt>" stem so a multi-speaker
            # src_dir can't pair against another speaker's same-numbered
            # utterance; fall back to suffix/equality matches
            ranked = ([s for st, s in stems_sorted if st == f"{src_spk}_{utt_id}"]
                      or [s for st, s in stems_sorted
                          if st == utt_id or st.endswith("_" + utt_id)])
            if ranked:
                pairs.append((ranked[0], fp))
        else:
            src_fp = by_stem.get(stem.split("_cv")[0])
            if src_fp:
                pairs.append((src_fp, fp))
    return pairs


def cmd_eval_mcd(args) -> int:
    import numpy as np

    from dvc_tpu_torch.eval.mcd import evaluate_mcd_wav
    from dvc_tpu_torch.utils.wavio import read_wav
    pairs = _pair_converted_to_source(args.src_dir, args.cvt_dir)
    src = [read_wav(s)[0] for s, _ in pairs]
    cvt = [read_wav(c)[0] for _, c in pairs]
    mcds = evaluate_mcd_wav(src, cvt, analysis=args.analysis, device=args.device)
    for (_, fp), m in zip(pairs, mcds):
        print(f"utterance {os.path.basename(fp)} mcd: {m}")
    finite = [m for m in mcds if np.isfinite(m)]
    print("MCD value between two speaker: ", float(np.mean(finite)) if finite else None)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dvc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("preprocess")
    p.add_argument("datasets_root")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("-d", "--dataset", default="VCTK")
    p.add_argument("-s", "--skip_existing", action="store_true")
    p.add_argument("--no_trim", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("eval-mcd")
    p.add_argument("--src_dir", required=True)
    p.add_argument("--cvt_dir", required=True)
    p.add_argument("--analysis", choices=["native", "device"], default="native",
                   help="native: Harvest and D4C in the C++ engine a wav at a time; "
                        "device: the corpus-batched WORLD analysis on --device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where CheapTrick and the mel-cepstrum run (and Harvest with "
                        "--analysis device); DTW runs on the host")
    p.set_defaults(fn=cmd_eval_mcd)

    p = sub.add_parser("preprocess-world")
    p.add_argument("dataset_fp")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--num_mcep", type=int, default=36)
    p.add_argument("--f0", choices=("native", "device"), default="native",
                   help="native: the C++ Harvest/D4C a wav at a time; device: the "
                        "batched Harvest, CheapTrick and mel-cepstrum on --device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_preprocess_world)

    p = sub.add_parser("train")
    _add_model_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("train-fs")
    _add_model_args(p)
    p.add_argument("--fs_epochs", type=int, default=10)
    p.set_defaults(fn=cmd_train_fs)

    p = sub.add_parser("convert")
    _add_model_args(p)
    p.add_argument("--src_spk", default="VCTK-Corpus_wav16_p225")
    p.add_argument("--trg_spk", default="VCTK-Corpus_wav16_p226")
    p.add_argument("--num_utterances", type=int, default=2)
    _add_vocoder_args(p)
    p.add_argument("--long_context", action="store_true",
                   help="encode whole utterances (the conv stack and biLSTM over "
                        "all frames) instead of independent 64-frame chunks")
    _add_fs_args(p)
    p.add_argument("--profile_transfer", action="store_true",
                   help="model-free DSP conversion: shift the source mel by the "
                        "difference of the speakers' mean profiles (no checkpoint)")
    p.add_argument("--analyze", action="store_true",
                   help="write the per-speaker latent analysis (and the FS mask "
                        "with --fs_mask) under <log_dir>/generation")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("convert-world")
    _add_model_args(p)
    p.add_argument("--src_spk", required=True)
    p.add_argument("--trg_spk", required=True)
    p.add_argument("--num_utterances", type=int, default=2)
    p.add_argument("--synth", choices=["native", "device"], default="native",
                   help="native: the C++ pulse synthesis a wav at a time; device: "
                        "the batched synthesis on --device")
    _add_fs_args(p)
    p.set_defaults(fn=cmd_convert_world)

    p = sub.add_parser("vocode")
    p.add_argument("mel_npy")
    p.add_argument("-o", "--out", default="")
    p.add_argument("--vocoder_ckpt", default="")
    p.add_argument("--gl_iters", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_vocode)

    p = sub.add_parser("train-vocoder")
    p.add_argument("wav_dir")
    p.add_argument("-m", "--models_dir", required=True)
    p.add_argument("--run_id", default="wavenet")
    p.add_argument("--n_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--max_time_steps", type=int, default=8000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--stacks", type=int, default=4)
    p.add_argument("--residual_channels", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arch", default="wavenet", choices=["wavenet", "istft"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_train_vocoder)

    p = sub.add_parser("serve")
    _add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--max_wait_ms", type=float, default=10.0,
                   help="micro-batching window: how long the worker waits to "
                        "aggregate concurrent requests into one batch")
    _add_vocoder_args(p)
    p.add_argument("--pipeline", default="mel", choices=["mel", "world"])
    _add_fs_args(p)
    p.add_argument("--profile_transfer", action="store_true",
                   help="serve the model-free DSP conversion (no checkpoint); "
                        "the vocoder is the only device work")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train-speaker")
    p.add_argument("run_id")
    p.add_argument("clean_data_root")
    p.add_argument("-m", "--models_dir", required=True)
    p.add_argument("--n_steps", type=int, default=10_000)
    p.add_argument("--speakers_per_batch", type=int, default=64)
    p.add_argument("--utterances_per_speaker", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--backup_every", type=int, default=3000)
    p.add_argument("--umap_every", type=int, default=100)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--no_resident_pool", action="store_true",
                   help="stream batches from the host instead of the device-resident "
                        "utterance pool")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_train_speaker)

    p = sub.add_parser("embed")
    p.add_argument("run_id")
    p.add_argument("wav_dir")
    p.add_argument("-m", "--models_dir", required=True)
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("eval-eer")
    p.add_argument("run_id")
    p.add_argument("mel_dir")
    p.add_argument("-m", "--models_dir", required=True)
    p.add_argument("--max_utts", type=int, default=50, help="utterances per speaker cap")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.set_defaults(fn=cmd_eval_eer)

    p = sub.add_parser("train-autovc")
    _add_model_args(p)
    p.add_argument("--encoder_run_id", default="",
                   help="GE2E run id for speaker embeddings (one-hot codes when omitted)")
    p.add_argument("-m", "--models_dir", default="",
                   help="GE2E models dir (with --encoder_run_id)")
    p.set_defaults(fn=cmd_train_autovc)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:  # a path the port has not yet: say so and stop
        raise SystemExit(str(e)) from e
    finally:
        _leave_ranks()


if __name__ == "__main__":
    sys.exit(main())

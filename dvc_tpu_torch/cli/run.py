"""CLI of the port: preprocess / train / convert / eval-mcd / serve / vocode
/ train-vocoder.

Same flags and defaults as dvc_tpu's commands (dvc_tpu/cli/run.py), plus
``--device {cuda,cpu}`` (default cuda; cuda without a card is an error).
The vocoder is Griffin-Lim by default (``--gl_iters``, 32); a bare
``--vocoder_ckpt`` selects the WaveNet vocoder (its sampler is the CUDA
kernel on cuda); ``--vocoder istft --vocoder_ckpt`` the iSTFT vocoder;
``--vocoder none`` returns mels.  ``--profile_transfer`` converts or serves
with the model-free DSP route.  ``train-vocoder`` trains the WaveNet (or,
with ``--arch istft``, the iSTFT vocoder) on a directory of wavs.  The
WORLD route, orbax checkpoints, ``eval-mcd --analysis device``,
``--analyze``, ``--long_context`` and ``--adv_cof`` are not ported yet and
exit with a message; dvc_tpu's other commands (train-fs, the speaker
encoder's, AutoVC's) are not here yet.

Usage (the verify recipe, then serving):
  python -m dvc_tpu_torch.cli.run preprocess <datasets_root> -o <mel_dir> -d VCTK [--no_trim]
  python -m dvc_tpu_torch.cli.run train --dataset_fp <mel_dir> --log_dir <run>
  python -m dvc_tpu_torch.cli.run convert --dataset_fp <mel_dir> --log_dir <run> \\
      --src_spk A --trg_spk B
  python -m dvc_tpu_torch.cli.run eval-mcd --src_dir <wavs> --cvt_dir <wavs>
  python -m dvc_tpu_torch.cli.run serve --dataset_fp <mel_dir> --log_dir <run>
  python -m dvc_tpu_torch.cli.run serve --dataset_fp <mel_dir> --profile_transfer
  python -m dvc_tpu_torch.cli.run vocode <mel.npy> [--vocoder_ckpt <r9y9 .pth | .msgpack>]
  python -m dvc_tpu_torch.cli.run train-vocoder <wav_dir> -m <models_dir> [--arch istft]
  python -m dvc_tpu_torch.cli.run convert ... --vocoder istft --vocoder_ckpt <istft .msgpack>
"""

from __future__ import annotations

import argparse
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
                   help="msgpack: dvc_tpu's TrainState .msgpack, with the reference's "
                        ".pth state dict and an .opt.pth beside it; orbax is not "
                        "ported yet")
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
    if args.features == "mcc":
        raise SystemExit(f"--features mcc (the WORLD route) is {NOT_PORTED}")
    if args.samples_length is None:
        args.samples_length = 64  # the reference's mel crop (train.py:53)
    vae = VAEConfig(latent_dim=args.latent_size, speaker_size=args.speaker_size,
                    frames=args.samples_length)
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
    """--fs_mask feature_mask.npz -> binary swap mask, or None."""
    if not args.fs_mask:
        return None
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
    return fs_mask


def cmd_preprocess(args) -> int:
    from dvc_tpu_torch.data.preprocess import preprocess_dataset
    stats = preprocess_dataset(args.datasets_root, args.out_dir, args.dataset,
                               skip_existing=args.skip_existing, trim=not args.no_trim,
                               device=args.device)
    print(f"preprocessed {stats.n_files} files ({stats.n_frames} mel frames), "
          f"skipped {stats.n_skipped}")
    return 0


def cmd_train(args) -> int:
    from dvc_tpu_torch.data.dataset import PairedMelDataset
    from dvc_tpu_torch.train.trainer import Trainer, unported_settings
    cfg = _config_from_args(args)
    bad = unported_settings(cfg)
    if bad:
        raise SystemExit(f"{', '.join(bad)}: {NOT_PORTED}")
    dataset = PairedMelDataset(args.dataset_fp, samples_length=args.samples_length,
                               seed=args.seed)
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    trainer = Trainer(cfg, checkpoints_path=os.path.join(args.log_dir, "checkpoints"),
                      logs_path=os.path.join(args.log_dir, "logs"), device=args.device)
    try:
        trainer.run_training(dataset, args.epochs, report_interval=args.report_interval,
                             reload_model=not args.do_not_resume)
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
                                     make_http_server)
    if args.pipeline == "world":
        if args.profile_transfer:
            raise SystemExit("--profile_transfer serves the mel pipeline only; "
                             "drop --pipeline world")
        raise SystemExit(f"--pipeline world is {NOT_PORTED}")
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
    vocoder = _make_cli_vocoder(args, cfg)  # a bad vocoder choice exits before any load
    fs_mask = _load_fs_mask(args, cfg)
    service = ConversionService(cfg, _load_model(args, cfg), args.dataset_fp, vocoder,
                                max_wait_ms=args.max_wait_ms, fs_mask=fs_mask,
                                device=args.device)
    _serve_forever(make_http_server(service, args.host, args.port),
                   f"{len(service.speakers())} target speakers, device {args.device}")
    return 0


def cmd_convert(args) -> int:
    from dvc_tpu_torch.convert.conversion import VoiceConverter
    from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32
    for flag in ("long_context", "analyze"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is {NOT_PORTED}")
    cfg = _config_from_args(args)
    device = resolve_device(args.device)
    model = None
    if args.profile_transfer:
        if args.fs_mask:
            raise SystemExit("--profile_transfer is model-free; --fs_mask does not apply")
    else:
        use_exact_float32()  # the VAE is served in float32, never TF32
    vocoder = _make_cli_vocoder(args, cfg)  # a bad vocoder choice exits before any load
    if not args.profile_transfer:
        model = _load_model(args, cfg).to(device).eval()
    converter = VoiceConverter(cfg, model, seed=args.seed, fs_mask=_load_fs_mask(args, cfg),
                               profile_transfer=args.profile_transfer)
    results = converter.convert_speaker_pair(
        args.dataset_fp, args.src_spk, args.trg_spk,
        os.path.join(args.log_dir, "generation"),
        num_utterances=args.num_utterances, vocoder=vocoder)
    print(f"converted {len(results)} utterances {args.src_spk} -> {args.trg_spk}")
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
                   help="device (dvc_tpu's corpus-batched device WORLD analysis) is "
                        "not ported yet")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where CheapTrick and the mel-cepstrum run; Harvest, D4C and "
                        "DTW run on the host")
    p.set_defaults(fn=cmd_eval_mcd)

    p = sub.add_parser("train")
    _add_model_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("convert")
    _add_model_args(p)
    p.add_argument("--src_spk", default="VCTK-Corpus_wav16_p225")
    p.add_argument("--trg_spk", default="VCTK-Corpus_wav16_p226")
    p.add_argument("--num_utterances", type=int, default=2)
    _add_vocoder_args(p)
    p.add_argument("--long_context", action="store_true")
    _add_fs_args(p)
    p.add_argument("--profile_transfer", action="store_true",
                   help="model-free DSP conversion: shift the source mel by the "
                        "difference of the speakers' mean profiles (no checkpoint)")
    p.add_argument("--analyze", action="store_true")
    p.set_defaults(fn=cmd_convert)

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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:  # a path the port has not yet: say so and stop
        raise SystemExit(str(e)) from e


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface: train / evaluate / decode / write-records /
export / serve / transcribe (counterpart of ``avsr_tpu/cli.py``).

A preset name or a JSON config file selects the experiment, and dotted-path
overrides reach every knob.  Commands that build a model or load an
artifact take ``--device`` (default ``cuda``; ``--device cpu`` runs the
plain PyTorch path on the CPU).

Examples:
  python -m avsr_tpu_torch.cli train --preset lrs2_av_fast \
      --set data.audio_train_records=train.tfrecord \
      --set train.learning_rate=3e-4
  python -m avsr_tpu_torch.cli evaluate --preset lrs2_av_align --run-dir runs/x
  python -m avsr_tpu_torch.cli write-records --synthetic 64 --out data/train.tfrecord
  python -m avsr_tpu_torch.cli export --preset lrs2_av_fast --run-dir runs/x \
      --set data.audio_eval_records=eval.tfrecord --out artifacts/fast --seconds 2,6,10
  python -m avsr_tpu_torch.cli serve --artifact artifacts/fast --port 8000
  python -m avsr_tpu_torch.cli transcribe --artifact artifacts/fast a.wav --video a.npy
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List


def _parse_overrides(pairs: List[str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass  # keep string
        out[k] = v
    return out


def _load_config(args):
    from avsr_tpu_torch.configs import PRESETS, ExperimentConfig

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    elif args.preset:
        if args.preset not in PRESETS:
            raise SystemExit(f"unknown preset {args.preset!r}; available: {sorted(PRESETS)}")
        cfg = PRESETS[args.preset]()
    else:
        cfg = ExperimentConfig()
    if args.set:
        try:
            cfg = cfg.override(_parse_overrides(args.set))
        except KeyError as e:
            raise SystemExit(f"unknown config key in --set: {e}")
    return cfg


def _build_avsr(args):
    from avsr_tpu_torch.avsr import AVSR

    return AVSR(config=_load_config(args), run_dir=args.run_dir, device=args.device)


def cmd_train(args) -> int:
    avsr = _build_avsr(args)
    metrics = avsr.train(num_epochs=args.epochs, logfile=args.logfile,
                         try_restore_latest_checkpoint=args.resume)
    print(json.dumps({"final": metrics}))
    return 0


def cmd_evaluate(args) -> int:
    avsr = _build_avsr(args)
    if getattr(args, "matrix", False):
        # per-(noise type x SNR) condition matrix; it restores the
        # checkpoint itself
        snrs: List[object] = [None]
        if args.snrs:
            snrs += [float(s) for s in args.snrs.split(",")]
        results = avsr.evaluate_noise_matrix(tuple(snrs), use_beam=not args.greedy,
                                             checkpoint=args.checkpoint)
        print(json.dumps(results))
        return 0
    metrics = avsr.evaluate(checkpoint=args.checkpoint, use_beam=not args.greedy)
    print(json.dumps(metrics))
    return 0


def cmd_decode(args) -> int:
    return cmd_evaluate(args)


def _write_bank(bank, path: str) -> None:
    from avsr_tpu_torch.data import tfrecord
    from avsr_tpu_torch.data.synthetic import Utterance

    tfrecord.write_dataset([Utterance(uid=f"noise{i}", transcript="", waveform=bank[i])
                            for i in range(bank.shape[0])], path)


def cmd_write_records(args) -> int:
    """Dataset serialization: a synthetic corpus, a real-media manifest, or
    a noise bank (synthetic or from recordings)."""
    from avsr_tpu_torch.data import tfrecord
    from avsr_tpu_torch.data.synthetic import SyntheticSpec, generate, make_noise_bank

    if args.manifest:
        if args.synthetic:
            raise SystemExit("--manifest and --synthetic are exclusive")
        if not args.out:
            raise SystemExit("--manifest requires --out")
        from avsr_tpu_torch.data.ingest import read_manifest, write_corpus

        n = write_corpus(read_manifest(args.manifest), args.out, video_codec=args.video_codec,
                         num_shards=args.shards, roi_size=args.roi_size,
                         log_every=args.log_every)
        print(f"wrote {n} utterances from {args.manifest} -> {args.out}")
        return 0
    if args.noise_wavs:
        # Noise bank from recordings: a list file (one wav path per line,
        # '#' comments) or comma-separated paths; one bank file per type.
        if not args.noise_out:
            raise SystemExit("--noise-wavs requires --noise-out")
        from avsr_tpu_torch.data.ingest import bank_from_wavs

        if "," in args.noise_wavs or args.noise_wavs.endswith(".wav"):
            wav_paths = [p for p in args.noise_wavs.split(",") if p]
        else:
            with open(args.noise_wavs) as f:
                wav_paths = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        bank = bank_from_wavs(wav_paths, row_samples=args.noise_samples)
        _write_bank(bank, args.noise_out)
        print(f"wrote noise bank ({bank.shape[0]} rows x {bank.shape[1]} samples from "
              f"{len(wav_paths)} recordings) -> {args.noise_out}")
        if not args.synthetic:
            return 0
    elif not args.synthetic and args.noise_out:
        # noise-bank-only write (one file per noise TYPE: run once per type)
        _write_bank(make_noise_bank(num_rows=4, row_samples=args.noise_samples,
                                    seed=args.seed + 1), args.noise_out)
        print(f"wrote noise bank -> {args.noise_out}")
        return 0
    if args.synthetic:
        if not args.out:
            raise SystemExit("--synthetic requires --out")
        utts = generate(SyntheticSpec(num_utterances=args.synthetic, seed=args.seed,
                                      min_chars=args.min_chars, max_chars=args.max_chars,
                                      char_duration_s=args.char_duration, roi=args.roi))
        paths = tfrecord.write_dataset(utts, args.out, video_codec=args.video_codec,
                                       num_shards=args.shards)
        print(f"wrote {len(utts)} synthetic utterances -> "
              f"{paths[0] if len(paths) == 1 else f'{len(paths)} shards'}")
        if args.noise_out and not args.noise_wavs:
            _write_bank(make_noise_bank(num_rows=4, row_samples=args.noise_samples,
                                        seed=args.seed + 1), args.noise_out)
            print(f"wrote noise bank -> {args.noise_out}")
        return 0
    raise SystemExit("pass --synthetic N (generated corpus) or --manifest FILE (real media: "
                     "wav/video/AU/landmark/ROI columns, see avsr_tpu_torch/data/ingest.py)")


def cmd_build_units(args) -> int:
    """Discover a unit inventory from corpus transcripts."""
    from avsr_tpu_torch.data import proto, tfrecord
    from avsr_tpu_torch.data import units as units_mod
    from avsr_tpu_torch.data.grain_loader import expand_pattern

    if not args.records and not args.manifest:
        raise SystemExit("build-units needs --records and/or --manifest")

    def transcripts():
        if args.records:
            for path in expand_pattern(args.records):
                for rec in tfrecord.iter_records(path):
                    ctx = proto.decode_sequence_example_context(rec)
                    yield ctx["transcript"][0].decode()
        if args.manifest:
            from avsr_tpu_torch.data.ingest import read_manifest

            for row in read_manifest(args.manifest):
                yield row["transcript"]

    d, counts, dropped = units_mod.from_transcripts(transcripts(), unit_type=args.unit_type,
                                                    min_count=args.min_count)
    d.save(args.out)
    total = sum(counts.values())
    kept_tokens = sum(c for u, c in counts.items() if u in d.unit_to_idx)
    print(json.dumps({
        "out": args.out,
        "unit_type": args.unit_type,
        "units": d.vocab_size - 3,  # excluding PAD/GO/EOS
        "vocab_size": d.vocab_size,
        "total_tokens": total,
        "dropped_below_min_count": dropped,
        "token_coverage_pct": round(100.0 * kept_tokens / max(total, 1), 4),
    }))
    return 0


def cmd_average_checkpoints(args) -> int:
    """Average the last-N checkpoints' parameters into a new checkpoint step."""
    avsr = _build_avsr(args)
    steps = [int(s) for s in args.steps.split(",")] if args.steps else None
    new_step = avsr.trainer.average_checkpoints(steps=steps, last_n=args.last)
    print(json.dumps({"averaged_step": new_step, "run_dir": avsr.trainer.run_dir}))
    return 0


def cmd_export(args) -> int:
    """Write a serving artifact (``avsr_tpu_torch/serve.py``: the parameters
    in the JAX tree's order and layout, the config and the request
    signature) from the run's checkpoint."""
    from avsr_tpu_torch.serve import export_serving_artifact

    avsr = _build_avsr(args)
    seconds = [float(s) for s in str(args.seconds).split(",")]
    out = export_serving_artifact(
        avsr, args.out, use_beam=not args.greedy, batch_size=args.batch_size,
        audio_seconds=seconds[0] if len(seconds) == 1 else seconds,
        platforms=tuple(args.platforms.split(",")) if args.platforms else None,
        # ints, step strings, paths, and "best" (best.json)
        checkpoint=avsr._resolve_checkpoint_step(args.checkpoint) if args.checkpoint else None,
        data_parallel=args.data_parallel, transfer=args.transfer, n_best=args.n_best)
    print(json.dumps({"artifact": out}))
    return 0


def cmd_serve(args) -> int:
    """Serve an artifact over HTTP with dynamic request batching
    (``avsr_tpu_torch/serve_host.py``): concurrent requests arriving within
    --max-wait-ms coalesce into one batched decode."""
    from avsr_tpu_torch.serve_host import make_server

    server, batcher = make_server(args.artifact, host=args.host, port=args.port,
                                  max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                                  device=args.device)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": args.artifact, "host": host, "port": port,
                      "max_batch": batcher.max_batch, "max_wait_ms": args.max_wait_ms}),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.close()
    return 0


def cmd_transcribe(args) -> int:
    """Transcribe media files with a serving artifact alone (no config, no
    checkpoint): ``.wav`` or ``.npy`` audio, ``.npy`` ROI arrays or video
    files (cv2 lip-ROI extraction) for video."""
    import numpy as np

    from avsr_tpu_torch.serve import BucketedPredictor, load_predictor

    pred = load_predictor(args.artifact, device=args.device)
    B = (min(p.batch_size for p in pred.buckets) if isinstance(pred, BucketedPredictor)
         else pred.batch_size)
    names = {i["name"] for i in pred.meta["inputs"]}
    need_audio, need_video = "audio" in names, "video" in names

    def load_audio(path):
        if path.endswith(".npy"):
            return np.asarray(np.load(path), np.float32)
        from avsr_tpu_torch.data.ingest import load_wav

        return load_wav(path)

    def load_video(path):
        if path.endswith(".npy"):
            v = np.asarray(np.load(path), np.float32)
            return v[..., None] if v.ndim == 3 else v
        from avsr_tpu_torch.data.ingest import extract_lip_rois

        return extract_lip_rois(path)

    files = list(args.inputs)
    videos = list(args.video or [])
    if need_video and not need_audio:
        # video-only artifact: the positional inputs ARE the videos
        files, videos = [], (videos or files)
    if need_audio and not files:
        raise SystemExit("artifact requires audio inputs (.wav or .npy)")
    if need_video and not videos:
        raise SystemExit("artifact requires video inputs: --video FILE per utterance (.npy ROI "
                         "array or a video file for cv2 extraction)")
    if need_audio and need_video and len(files) != len(videos):
        raise SystemExit(f"{len(files)} audio but {len(videos)} video inputs")

    want_n = max(int(args.n_best or 1), 1)
    if want_n > 1 and pred.n_best < want_n:
        raise SystemExit(f"--n-best {want_n} but the artifact was exported with "
                         f"n_best={pred.n_best}; re-export with --n-best {want_n}")
    keys = files if need_audio else videos
    results: list = []
    for lo in range(0, len(keys), B):
        kw = {}
        if need_audio:
            kw["audio"] = [load_audio(p) for p in files[lo:lo + B]]
        if need_video:
            kw["video"] = [load_video(p) for p in videos[lo:lo + B]]
        results.extend(pred.transcribe_nbest(**kw) if want_n > 1 else pred.transcribe(**kw))

    out_f = open(args.out, "w") if args.out else None
    try:
        for name, r in zip(keys, results):
            if want_n > 1:
                line = json.dumps({"file": name, "text": r[0][0], "alternatives": [
                    {"text": t, "score": s} for t, s in r[:want_n]]})
            else:
                line = json.dumps({"file": name, "text": r})
            print(line)
            if out_f:
                out_f.write(line + "\n")
    finally:
        if out_f:
            out_f.close()
    return 0


def cmd_show_config(args) -> int:
    print(_load_config(args).to_json())
    return 0


def cmd_analyze(args) -> int:
    """Error analysis over a predictions file (confusions, distributions,
    worst utterances, bootstrap intervals, paired comparison)."""
    from avsr_tpu_torch.eval.analysis import analyze_file, bootstrap_ci, compare, \
        parse_predictions

    path = args.predictions
    if path is None:
        if not args.run_dir:
            raise SystemExit("pass --predictions FILE or --run-dir DIR")
        cands = sorted(glob.glob(os.path.join(args.run_dir, "predictions_*.txt")),
                       key=os.path.getmtime)
        if not cands:
            raise SystemExit(f"no predictions_*.txt under {args.run_dir}")
        path = cands[-1]
    report = analyze_file(path, top=args.top)
    report["predictions_file"] = path
    if args.bootstrap:
        report["bootstrap"] = bootstrap_ci(parse_predictions(path), n_resamples=args.bootstrap)
    if args.compare:
        report["compare"] = compare(parse_predictions(path), parse_predictions(args.compare),
                                    n_resamples=args.bootstrap or 2000, top=args.top)
        report["compare"]["b_predictions_file"] = args.compare
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="avsr_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def config_args(p):
        p.add_argument("--preset", help="named experiment preset")
        p.add_argument("--config", help="JSON config file")
        p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                       help="dotted-path config override")
        p.add_argument("--run-dir", default=None)

    def model_args(p):
        config_args(p)
        p.add_argument("--device", default="cuda",
                       help="torch device of the model and the batches (default cuda; "
                            "cpu runs the plain PyTorch path)")

    p = sub.add_parser("train", help="train a model")
    model_args(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--logfile", default=None)
    p.add_argument("--resume", action="store_true", help="try_restore_latest_checkpoint")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate a checkpoint")
    model_args(p)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--greedy", action="store_true", help="greedy instead of beam")
    p.add_argument("--matrix", action="store_true",
                   help="per-(noise type x SNR) condition matrix")
    p.add_argument("--snrs", default=None,
                   help="comma-separated SNRs for --matrix (clean always runs)")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("decode", help="beam-decode the eval set")
    model_args(p)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--greedy", action="store_true")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("write-records", help="serialize a dataset to TFRecords")
    p.add_argument("--synthetic", type=int, default=0, help="generate N synthetic utterances")
    p.add_argument("--manifest", default=None,
                   help="real-media corpus manifest (CSV/TSV, header with 'uid' + any of "
                        "transcript, transcript_file, wav, video, au_csv, landmarks_csv, "
                        "roi_npy; relative paths resolve against the manifest)")
    p.add_argument("--roi-size", type=int, default=36,
                   help="lip-ROI side length for --manifest video extraction")
    p.add_argument("--log-every", type=int, default=100,
                   help="progress line every N utterances (--manifest)")
    p.add_argument("--out", default=None, help="corpus output path (required with --synthetic)")
    p.add_argument("--noise-out", default=None)
    p.add_argument("--noise-wavs", default=None,
                   help="build the noise bank from recordings: a list file (one wav path per "
                        "line) or comma-separated wav paths; run once per noise type")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-chars", type=int, default=2)
    p.add_argument("--max-chars", type=int, default=6)
    p.add_argument("--char-duration", type=float, default=0.12,
                   help="seconds per character (sets utterance durations)")
    p.add_argument("--roi", type=int, default=36, help="lip-ROI side length")
    p.add_argument("--noise-samples", type=int, default=160_000,
                   help="samples per noise-bank row")
    p.add_argument("--video-codec", default="float32", choices=("float32", "uint8"),
                   help="ROI storage codec (uint8 = 4x smaller records)")
    p.add_argument("--shards", type=int, default=1,
                   help="split the corpus into N shard files (read back via the glob '<out>-*')")
    p.set_defaults(fn=cmd_write_records)

    p = sub.add_parser("build-units", help="discover a unit inventory from corpus transcripts")
    p.add_argument("--records", default=None,
                   help="record path / shard glob / comma list to scan")
    p.add_argument("--manifest", default=None, help="corpus manifest (CSV/TSV) to scan")
    p.add_argument("--unit-type", default="character",
                   help="tokenization: character* = lowercased chars, anything else = "
                        "whitespace units")
    p.add_argument("--min-count", type=int, default=1,
                   help="drop units seen fewer than N times (reported)")
    p.add_argument("--out", required=True,
                   help="unit file to write (use via data.unit_file + data.unit_type)")
    p.set_defaults(fn=cmd_build_units)

    p = sub.add_parser("export", help="write a serving artifact from the run's checkpoint")
    model_args(p)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--checkpoint", default=None, help="a step, a step directory or 'best'")
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seconds", default="6.0",
                   help="audio horizon(s); a comma-separated list writes one bucket a horizon "
                        "(e.g. 2,6,10)")
    p.add_argument("--platforms", default="cpu,gpu",
                   help="comma-separated platforms the artifact serves on: the port's "
                        "artifacts run on both cpu and gpu")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="data-parallel artifact over N devices (not ported: raises)")
    p.add_argument("--transfer", default="compact", choices=("compact", "float32"),
                   help="request wire dtypes: compact = int16 PCM audio / uint8 ROI video, "
                        "dequantized on the device (2-4x fewer host-to-device bytes)")
    p.add_argument("--n-best", type=int, default=1,
                   help="keep the ranked top-N hypotheses + scores (beam only); serving "
                        "still returns top-1 by default")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("average-checkpoints",
                       help="average the last-N checkpoints into a new checkpoint step")
    model_args(p)
    p.add_argument("--last", type=int, default=5, help="how many newest checkpoints to average")
    p.add_argument("--steps", default=None,
                   help="explicit comma-separated steps instead of --last")
    p.set_defaults(fn=cmd_average_checkpoints)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device the artifact is loaded on (default cuda; cpu runs "
                            "the plain PyTorch path)")

    p = sub.add_parser("serve", help="serve an artifact over HTTP with dynamic batching")
    p.add_argument("--artifact", required=True, help="artifact directory from `export`")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = pick an ephemeral port (printed on startup)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="cap coalesced batch size (default: the artifact's batch size)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long the first request in a batch waits for company")
    device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("transcribe", help="transcribe media files with a serving artifact")
    p.add_argument("--artifact", required=True, help="artifact directory written by `export`")
    p.add_argument("inputs", nargs="+",
                   help=".wav or .npy waveform files (video-only artifacts: the video "
                        "files / ROI .npy arrays)")
    p.add_argument("--video", action="append", default=None,
                   help="one per utterance: .npy ROI array [T,h,w(,1)] or a video file for "
                        "cv2 lip-ROI extraction")
    p.add_argument("--out", default=None, help="also write the JSONL transcripts here")
    p.add_argument("--n-best", type=int, default=1,
                   help="emit the top-N ranked alternatives with scores (artifact exported "
                        "with --n-best >= N)")
    device_arg(p)
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("show-config", help="print the resolved config")
    config_args(p)
    p.set_defaults(fn=cmd_show_config)

    p = sub.add_parser("analyze", help="error analysis over a predictions file (confusions, "
                                       "CER distribution, worst utterances)")
    p.add_argument("--predictions", default=None,
                   help="predictions_*.txt file (default: newest in --run-dir)")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--top", type=int, default=10,
                   help="list length for confusions / worst utterances")
    p.add_argument("--bootstrap", type=int, nargs="?", const=2000, default=0, metavar="N",
                   help="bootstrap 95%% confidence intervals on CER/WER (N resamples, "
                        "default 2000)")
    p.add_argument("--compare", default=None, metavar="PREDICTIONS_B",
                   help="second predictions file: paired-bootstrap significance test "
                        "(A = --predictions, B = this)")
    p.set_defaults(fn=cmd_analyze)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Serving: the artifact, the loading ``Predictor`` and bucketed serving.

Counterpart of ``avsr_tpu/serve.py`` for every architecture the port runs
(``audio``, ``video`` with the ROI CNN or AU features, ``bimodal``, and
``av_align``: ``lrs2_av_fast``, BiLSTM encoders, cross-attention fusion +
transformer decoder; ``lrs2_av_align``, AV-Align fusion + attention-LSTM
decoder, with BiLSTM encoders and Bahdanau reads or one-direction encoders
and Luong reads; ``lrs2_av_v2``, transformer encoders, cross-attention
fusion + transformer decoder): the inputs the architecture reads, the same
static (B, S) request shape, the same host quantization for compact
transfer (int16 PCM audio, uint8 ROI pixels, dequantized on the device
inside ``seq2seq.encode``), the same ``decode_ids`` rules, greedy, beam and
n-best artifacts.

Artifact layout (one directory), as the reference writes it but for the
program file:

  params.npz   the parameter leaves as ``leaf_%05d``, in the JAX tree's
               ``tree_flatten`` order and layout (``convert.leaf_to_jax``):
               the arrays the JAX package writes for the same parameters
  meta.json    the reference's keys (input names / shapes / dtypes, the unit
               inventory without the specials, the PAD / GO / EOS ids,
               platforms, devices, the export's extra keys), with
               ``torch_version`` in place of ``jax_version`` and
               ``calling_convention``, and ``config``
               (``ExperimentConfig.to_dict()``), from which ``Predictor.load``
               rebuilds the model

There is no lowered program: the port's kernels are ctypes calls and its
beam search a host loop with an early exit, so the artifact is the
parameters plus the config, and the port's own model code runs them.
``platforms`` is ``["cpu", "gpu"]``: the artifact runs wherever the port
runs.  A directory the JAX package wrote (a ``decode.jaxexport`` program, no
``config``) is refused.

``Predictor.load`` places the parameters on its device once, so a request
pays only for its own input bytes; ``encode``, ``beam``, ``greedy`` and
``__call__`` run under ``torch.inference_mode()``, so parameters that
require a gradient (a train state's) record no graph.  ``BucketedPredictor``
routes a request to the smallest exported horizon that fits it.

>>> p = load_predictor("artifacts/av_6s_b8")  # on the card; device="cpu" for the plain path
>>> p.transcribe(audio=[wav1, wav2], video=[roi1, roi2])
>>> Predictor(params, cfg, unit_dict).transcribe(audio=[wav1, wav2], video=[roi1, roi2])
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from avsr_tpu_torch import convert
from avsr_tpu_torch.configs import ExperimentConfig
from avsr_tpu_torch.data.units import EOS_ID, GO_ID, PAD_ID, UnitDict
from avsr_tpu_torch.decode.beam import BeamResult, beam_search
from avsr_tpu_torch.decode.greedy import GreedyResult, greedy_decode
from avsr_tpu_torch.models import seq2seq
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import Params

PARAMS_FILE = "params.npz"
META_FILE = "meta.json"
JAX_PROGRAM_FILE = "decode.jaxexport"  # the JAX package's lowered program
PLATFORMS = ("cpu", "gpu")


def input_signature(cfg: ExperimentConfig, batch_size: int, audio_seconds: float,
                    video_seconds: Optional[float], transfer: str) -> List[Tuple[str, tuple, str]]:
    """(name, shape, dtype) of each array the architecture reads
    (``avsr_tpu/serve.py:_input_signature``): compact transfer ships int16
    PCM audio and uint8 ROI video; AU-feature video stays float32 (its
    intensities are not bounded to [0, 1])."""
    if video_seconds is None:
        video_seconds = audio_seconds
    compact = transfer == "compact"
    sig: List[Tuple[str, tuple, str]] = []
    if seq2seq.uses_audio(cfg):
        S = int(round(audio_seconds * cfg.audio.sample_rate))
        sig.append(("audio", (batch_size, S), "int16" if compact else "float32"))
        sig.append(("audio_lengths", (batch_size,), "int32"))
    if seq2seq.uses_video(cfg):
        T_v = int(math.ceil(video_seconds * cfg.data.video_fps))
        v = cfg.video
        if v.use_au_features:
            shape, vdt = (batch_size, T_v, v.au_dim), "float32"
        else:
            shape = (batch_size, T_v, v.roi_height, v.roi_width, v.channels)
            vdt = "uint8" if compact else "float32"
        sig.append(("video", shape, vdt))
        sig.append(("video_lengths", (batch_size,), "int32"))
    return sig


def quantize(name: str, s: np.ndarray, dtype: str) -> np.ndarray:
    """Float request -> wire dtype (host-side half of compact transfer)."""
    if dtype == "int16":
        if np.issubdtype(s.dtype, np.integer):
            return s.astype(np.int16)
        lo, hi = (float(s.min()), float(s.max())) if s.size else (0.0, 0.0)
        # full-scale 16-bit PCM spans [-32768/32767, 1] after load_wav's
        # /32767: a clipped recording's most negative sample is valid
        if lo < -32768.0 / 32767.0 - 1e-6 or hi > 1.0 + 1e-6:
            raise ValueError(
                f"{name} request range [{lo:.4f}, {hi:.4f}]; compact artifacts expect "
                "int16-PCM-range waveforms in [-32768/32767, 1]")
        return np.clip(np.round(s * 32767.0), -32768, 32767).astype(np.int16)
    if dtype == "uint8":
        if s.dtype == np.uint8:
            return s
        lo, hi = (float(s.min()), float(s.max())) if s.size else (0.0, 0.0)
        if lo < -1e-6 or hi > 1.0 + 1e-6:
            raise ValueError(
                f"{name} request range [{lo:.3f}, {hi:.3f}]; compact artifacts expect "
                "ROI pixels in [0, 1]")
        return np.round(s * 255.0).astype(np.uint8)
    return s.astype(dtype)


class ExportedDecode(NamedTuple):
    """What an artifact decodes with, the port's stand-in for the
    reference's lowered ``Exported``: the config the model is rebuilt from,
    beam or greedy, the ranked alternatives kept."""
    config: ExperimentConfig
    use_beam: bool
    n_best: int


def _decode_program(cfg: ExperimentConfig, use_beam: bool, n_best: int,
                    platforms: Optional[Sequence[str]]) -> ExportedDecode:
    """The reference's export-time checks: ``n_best`` within the beam,
    ranked alternatives only from a beam, platforms the port runs on."""
    if n_best > cfg.decode.beam_width:
        raise ValueError(
            f"n_best {n_best} exceeds decode.beam_width {cfg.decode.beam_width}: the beam "
            "cannot rank more leaves than it keeps")
    beam = bool(use_beam and cfg.decode.beam_width > 1)
    if n_best > 1 and not beam:
        raise ValueError("n_best > 1 requires beam decoding (use_beam=True, "
                         "decode.beam_width > 1)")
    other = sorted(set(platforms or ()) - set(PLATFORMS))
    if other:
        raise ValueError(f"platforms {other}: the port runs on {list(PLATFORMS)}, and its "
                         "artifacts run on both")
    return ExportedDecode(cfg, beam, int(n_best))


def export_decode(params: Params, cfg: ExperimentConfig, *, use_beam: bool = True,
                  batch_size: int = 8, audio_seconds: float = 6.0,
                  video_seconds: Optional[float] = None,
                  platforms: Optional[Sequence[str]] = None, transfer: str = "float32",
                  n_best: int = 1):
    """The decode program of an artifact: (``ExportedDecode``, the parameter
    leaves as numpy in the JAX tree's flatten order and layout, the input
    signature), as ``avsr_tpu/serve.py:export_decode`` returns (exported,
    leaves, signature).  ``n_best > 1`` (beam only) decodes to
    ``(ids [B, N, L], scores [B, N])`` ranked best-first."""
    program = _decode_program(cfg, use_beam, n_best, platforms)
    sig = input_signature(cfg, batch_size, audio_seconds, video_seconds, transfer)
    leaves = [x for _, x in convert.jax_order_leaves(convert.to_jax_numpy(params))]
    return program, leaves, sig


def _artifact_meta(program: ExportedDecode, sig, unit_dict: UnitDict,
                   extra_meta: Optional[Dict] = None) -> Dict:
    meta = {
        "inputs": [{"name": n, "shape": list(s), "dtype": d} for n, s, d in sig],
        # the inventory WITHOUT the 3 specials (ids 3..), as UnitDict.save writes it
        "units": list(unit_dict.idx_to_unit[3:]),
        "unit_type": unit_dict.unit_type,
        "pad_id": PAD_ID, "go_id": GO_ID, "eos_id": EOS_ID,
        "platforms": list(PLATFORMS),
        "num_devices": 1,
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta.update(extra_meta)
    # what the artifact decodes with is the program's, whatever the extras say
    meta.update(use_beam=program.use_beam, n_best=program.n_best,
                config=program.config.to_dict())
    return meta


def save_artifact(out_dir: str, exported: ExportedDecode, params_leaves, sig,
                  unit_dict: UnitDict, *, extra_meta: Optional[Dict] = None) -> str:
    """Write the serving artifact directory; returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, PARAMS_FILE),
             **{f"leaf_{i:05d}": x for i, x in enumerate(params_leaves)})
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(_artifact_meta(exported, sig, unit_dict, extra_meta), f, indent=1)
    return out_dir


class Predictor:
    """Encode + greedy, beam or n-best decode of fixed-shape request
    batches.  ``Predictor(params, cfg, unit_dict, ...)`` serves parameters
    in process; ``Predictor.load(path)`` serves an artifact."""

    def __init__(self, params: Params, cfg: ExperimentConfig, unit_dict: UnitDict, *,
                 device="cuda", batch_size: int = 8, audio_seconds: float = 6.0,
                 video_seconds: Optional[float] = None, transfer: str = "compact",
                 use_beam: bool = True, n_best: int = 1):
        program = _decode_program(cfg, use_beam, n_best, None)
        sig = input_signature(cfg, batch_size, audio_seconds, video_seconds, transfer)
        self._setup(params, cfg, _artifact_meta(program, sig, unit_dict), device)

    def _setup(self, params: Params, cfg: ExperimentConfig, meta: Dict, device) -> None:
        self.params = params
        self.cfg = cfg
        self.device = device
        self.meta = meta
        self._inputs = {i["name"]: i for i in meta["inputs"]}
        self._units = meta["units"]
        self._cdt = compute_dtype_of(cfg)

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "Predictor":
        """Rebuild the config, the unit inventory and the parameters from
        the artifact directory alone, the parameters placed on ``device``
        once."""
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        if "config" not in meta:
            if os.path.exists(os.path.join(path, JAX_PROGRAM_FILE)):
                raise ValueError(
                    f"{path} is an artifact of the JAX package ({JAX_PROGRAM_FILE}, no config): "
                    "re-export it with avsr_tpu_torch (cli export, export_serving_artifact)")
            raise ValueError(f"{path}: {META_FILE} has no config to rebuild the model from")
        cfg = ExperimentConfig.from_dict(meta["config"])
        units = UnitDict(meta["units"], meta["unit_type"])
        with np.load(os.path.join(path, PARAMS_FILE)) as z:
            leaves = [z[k] for k in sorted(z.files)]
        template = seq2seq.model_init(cfg, units.vocab_size, torch.Generator(), device="meta")
        p = cls.__new__(cls)
        p._setup(convert.from_jax_leaves(template, leaves, device=device), cfg, meta, device)
        return p

    @property
    def batch_size(self) -> int:
        return int(self.meta["inputs"][0]["shape"][0])

    @property
    def n_best(self) -> int:
        return int(self.meta["n_best"])

    @property
    def use_beam(self) -> bool:
        return bool(self.meta["use_beam"])

    def _pad_batch(self, name: str, seqs: Sequence[np.ndarray]):
        spec = self._inputs[name]
        shape, dtype = tuple(spec["shape"]), spec["dtype"]
        if len(seqs) > shape[0]:
            raise ValueError(
                f"{len(seqs)} {name} inputs exceed the exported batch size {shape[0]}; "
                "export a larger bucket or split the request")
        out = np.zeros(shape, dtype)
        lengths = np.zeros((shape[0],), np.int32)
        for i, s in enumerate(seqs):
            s = np.asarray(s)
            out[i, : s.shape[0]] = self._check_and_quantize(name, i, s, shape, dtype)
            lengths[i] = s.shape[0]
        return out, lengths

    def _check_and_quantize(self, name, i, s, shape, dtype):
        """Everything ``_pad_batch`` rejects for one utterance (horizon,
        trailing shape, quantize range)."""
        if s.shape[0] > shape[1]:
            raise ValueError(
                f"{name} input {i} has {s.shape[0]} steps; exported horizon is {shape[1]} — "
                "export a longer bucket")
        if s.shape[1:] != shape[2:]:
            raise ValueError(
                f"{name} input {i} trailing shape {s.shape[1:]} != exported {shape[2:]}")
        return quantize(name, s, dtype)

    def validate_utterance(self, audio=None, video=None) -> None:
        """Raise the error ``_pad_batch`` would raise for this one utterance:
        serving hosts call it at submit time, so one client's bad input
        fails its own request instead of a coalesced batch."""
        for name, s in (("audio", audio), ("video", video)):
            if s is None or name not in self._inputs:
                continue
            spec = self._inputs[name]
            self._check_and_quantize(name, 0, np.asarray(s), tuple(spec["shape"]),
                                     spec["dtype"])

    def assemble(self, audio: Optional[Sequence[np.ndarray]] = None,
                 video: Optional[Sequence[np.ndarray]] = None):
        """Pad and quantize a request: (host arrays by input name, count).
        Each modality the architecture reads is required; one it does not
        read is ignored (``avsr_tpu/serve.py:_assemble``)."""
        n = None
        arrays: Dict[str, np.ndarray] = {}
        for name, seqs in (("audio", audio), ("video", video)):
            if name not in self._inputs:
                continue
            if seqs is None:
                raise ValueError(f"the {self.cfg.architecture} model needs {name}")
            arrays[name], arrays[f"{name}_lengths"] = self._pad_batch(name, seqs)
            if n is None:
                n = len(seqs)
            elif len(seqs) != n:
                raise ValueError("audio/video request counts differ")
        if not n:
            raise ValueError("empty request: no utterances")
        return arrays, n

    @torch.inference_mode()
    def encode(self, arrays: Dict[str, np.ndarray]) -> seq2seq.EncodeOutput:
        return seq2seq.encode(self.params, self.cfg,
                              seq2seq.batch_to_device(arrays, self.device))

    @torch.inference_mode()
    def beam(self, enc_out: seq2seq.EncodeOutput) -> BeamResult:
        d = self.cfg.decode
        return beam_search(self.params["decoder"], self.cfg.decoder, enc_out.memories,
                           d.max_decode_length, beam_width=d.beam_width,
                           length_penalty=d.length_penalty, cdt=self._cdt, n_best=self.n_best)

    @torch.inference_mode()
    def greedy(self, enc_out: seq2seq.EncodeOutput) -> GreedyResult:
        return greedy_decode(self.params["decoder"], self.cfg.decoder, enc_out.memories,
                             self.cfg.decode.max_decode_length, cdt=self._cdt)

    @torch.inference_mode()
    def __call__(self, **arrays):
        """Padded full-shape arrays in, hypothesis ids [B, L] out, or
        ``(nbest_ids [B, N, L], nbest_scores [B, N])`` for an n-best
        artifact; a greedy artifact decodes greedily
        (``avsr_tpu/serve.py:148-156``)."""
        enc = self.encode(arrays)
        if not self.use_beam:
            return self.greedy(enc).ids.numpy()
        res = self.beam(enc)
        if self.n_best > 1:
            return res.nbest_ids.numpy(), res.nbest_scores.numpy()
        return res.ids.numpy()

    def decode_ids(self, ids: np.ndarray) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in (PAD_ID, GO_ID) or not 0 <= i - 3 < len(self._units):
                continue
            toks.append(self._units[i - 3])
        return ("" if self.meta["unit_type"].startswith("character") else " ").join(toks)

    def transcribe(self, *, audio: Optional[Sequence[np.ndarray]] = None,
                   video: Optional[Sequence[np.ndarray]] = None) -> List[str]:
        """Variable-length utterances in, transcripts out."""
        arrays, n = self.assemble(audio, video)
        out = self(**arrays)
        ids = out[0][:, 0] if isinstance(out, tuple) else out  # n-best: rank 0 wins
        return [self.decode_ids(ids[i]) for i in range(n)]

    def transcribe_nbest(self, *, audio: Optional[Sequence[np.ndarray]] = None,
                         video: Optional[Sequence[np.ndarray]] = None
                         ) -> List[List[Tuple[str, float]]]:
        """Per utterance: ranked [(hypothesis, score), ...] alternatives.
        Requires an artifact exported with ``n_best > 1``."""
        if self.n_best <= 1:
            raise ValueError("artifact was exported top-1 only; re-export with --n-best N for "
                             "ranked alternatives")
        arrays, n = self.assemble(audio, video)
        ids, scores = self(**arrays)
        return [[(self.decode_ids(ids[i, r]), float(scores[i, r])) for r in range(ids.shape[1])]
                for i in range(n)]


class BucketedPredictor:
    """Routes each request to the smallest exported bucket that fits it, so
    a 2 s utterance does not pay a 10 s program; the same ``transcribe``
    surface as ``Predictor``."""

    def __init__(self, buckets: List[Predictor]):
        if not buckets:
            raise ValueError("no buckets")
        # ascending by the first input's horizon
        self.buckets = sorted(
            buckets, key=lambda p: p._inputs[p.meta["inputs"][0]["name"]]["shape"][1])
        self.meta = self.buckets[-1].meta

    def _pick(self, audio, video) -> Predictor:
        # an empty request falls through to a Predictor's "empty request"
        # error instead of a bare max() error
        if not audio and not video:
            return self.buckets[0]
        for p in self.buckets:
            ok = True
            if audio and "audio" in p._inputs:
                ok = ok and max(len(a) for a in audio) <= p._inputs["audio"]["shape"][1]
            if video and "video" in p._inputs:
                ok = ok and max(len(v) for v in video) <= p._inputs["video"]["shape"][1]
            if ok:
                return p
        return self.buckets[-1]  # an overrun raises there, with the message

    def validate_utterance(self, audio=None, video=None) -> None:
        # the largest bucket's horizon is the artifact's true limit
        self.buckets[-1].validate_utterance(audio=audio, video=video)

    def transcribe(self, *, audio=None, video=None) -> List[str]:
        return self._pick(audio, video).transcribe(audio=audio, video=video)

    @property
    def n_best(self) -> int:
        return min(p.n_best for p in self.buckets)

    def transcribe_nbest(self, *, audio=None, video=None):
        return self._pick(audio, video).transcribe_nbest(audio=audio, video=video)


def load_predictor(path: str, *, device="cuda"):
    """Load a serving artifact directory: one bucket or a bucketed set."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if "buckets" in meta:
        return BucketedPredictor([Predictor.load(os.path.join(path, b["path"]), device=device)
                                  for b in meta["buckets"]])
    return Predictor.load(path, device=device)


def _horizons(audio_seconds) -> List[float]:
    """A number, a sequence, or a ``"2,6,10"`` string -> sorted horizons.
    A string is never iterated by character: "10" is one 10 s bucket."""
    if isinstance(audio_seconds, str):
        return sorted(float(p) for p in audio_seconds.split(",") if p.strip())
    try:
        return sorted(float(s) for s in audio_seconds)
    except TypeError:
        return [float(audio_seconds)]


def export_serving_artifact(avsr, out_dir: str, *, use_beam: bool = True, batch_size: int = 8,
                            audio_seconds: "float | Sequence[float] | str" = 6.0,
                            video_seconds: Optional[float] = None,
                            platforms: Optional[Sequence[str]] = PLATFORMS,
                            checkpoint: Optional[int] = None,
                            data_parallel: Optional[int] = None, transfer: str = "compact",
                            n_best: int = 1) -> str:
    """``AVSR``-level export: restore, then write the artifact
    (``avsr_tpu/serve.py:export_serving_artifact``).

    Restores as ``predict`` does: an explicit ``checkpoint`` step, else the
    latest checkpoint when nothing was trained this session; a
    never-trained model raises.  Several horizons (a sequence, or a
    ``"2,6,10"`` string) write one bucket a horizon under
    ``out_dir/bucket_<s>s`` with a root manifest, which ``load_predictor``
    routes by.  ``transfer`` defaults to "compact" (int16 PCM / uint8 ROI
    on the wire, dequantized on the device).  Data-parallel artifacts
    (``data_parallel > 1``) are not ported."""
    if data_parallel is not None and data_parallel > 1:
        dev = torch.device(avsr.trainer.device)
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        if n_dev < data_parallel:
            raise ValueError(f"data_parallel={data_parallel} but only {n_dev} devices visible "
                             "at export time")
        raise NotImplementedError(
            f"data_parallel={data_parallel}: data-parallel artifacts are not ported "
            "(multi-GPU: ROADMAP.md queue 1 item 8); export one device's artifact")
    trainer = avsr.trainer
    if checkpoint is not None:
        trainer.state, _, step = trainer.ckpt.restore(trainer.state, step=checkpoint)
        trainer._host_step = int(step)
    elif trainer._host_step == 0:
        if trainer.ckpt.latest_step() is None:
            raise RuntimeError(
                "export on a never-trained model: no checkpoint under "
                f"{trainer.ckpt.directory} and no training this session")
        trainer.state, _, step = trainer.ckpt.restore(trainer.state)
        trainer._host_step = int(step)

    def one(out: str, seconds: float) -> str:
        program, leaves, sig = export_decode(
            trainer.state.params, avsr.config, use_beam=use_beam, batch_size=batch_size,
            audio_seconds=seconds, video_seconds=video_seconds, platforms=platforms,
            transfer=transfer, n_best=n_best)
        return save_artifact(out, program, leaves, sig, avsr.unit_dict, extra_meta={
            "architecture": avsr.config.architecture,
            "use_beam": program.use_beam,
            "checkpoint_step": int(trainer._host_step),
            "audio_seconds": seconds,
            "transfer": transfer,
            "n_best": int(n_best),
        })

    horizons = _horizons(audio_seconds)
    if len(horizons) == 1:
        return one(out_dir, horizons[0])
    os.makedirs(out_dir, exist_ok=True)
    buckets = []
    for s in horizons:
        sub = f"bucket_{s:g}s"
        one(os.path.join(out_dir, sub), s)
        buckets.append({"audio_seconds": s, "path": sub})
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump({"buckets": buckets, "architecture": avsr.config.architecture}, f, indent=1)
    return out_dir

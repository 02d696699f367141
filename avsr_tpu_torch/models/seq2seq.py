"""Model assembly and the loss (counterpart of ``avsr_tpu/models/seq2seq.py``).

The port runs every architecture of the reference, switched on
``cfg.architecture``:

* ``audio``: the log-mel frontend and the audio encoder; the decoder reads
  its output (``audio_tcdtimit``);
* ``video``: the lip-ROI CNN (or, with ``video.use_au_features``, the
  linear AU-feature bypass) and the video encoder (``video_tcdtimit``);
* ``bimodal``: both encoders; the decoder reads the audio and the video
  memory, one attention each, and concatenates the contexts
  (``bimodal_tcdtimit``);
* ``av_align``, in two structures: cross-attention fusion and the
  transformer decoder (``lrs2_av_fast``, with BiLSTM encoders, and the
  scan-free ``lrs2_av_v2``, with transformer encoders), or the recurrent
  AV-Align fusion (the fusion LSTM with a Bahdanau or Luong read of the
  video memory, fused memory [h ; ctx]) and the attention-LSTM decoder with
  scheduled sampling (``lrs2_av_align``, ``av_align_tcdtimit``,
  ``av_align_noisy`` and ``lrs2_av_align_uni_luong``).

The unimodal and bimodal architectures take either decoder type.  Compact
int16/uint8 inputs are dequantized on the device; in training the waveform
is mixed with noise, in evaluation with the fixed (type, SNR) condition of
``cfg.noise`` (``ops/noise.py:mix_fixed_snr``); audio goes through the
log-mel frontend and its encoder stack (pyramidal (Bi)LSTM, or
transformer), video through its frontend and encoder, and the memories are
prepared for the decoder (value-only for the transformer, the keys of its
attention type for the RNN decoder).  ``loss_fn`` adds the teacher-forced
decoder, the cross-entropy and (``av_align``) the AU regression loss;
``loss_given_encode`` does the same from an encode already made.

Randomness (noise draws, dropout masks) comes from ONE generator per
call, drawn in a fixed order: noise, SpecAugment's masks (``cfg.audio.
spec_augment``, train mode, after the frontend), the audio encoder's
layers, the video encoder's, then the decoder's.

``train.remat`` (train mode) runs each encoder stack under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
``encoder_apply`` in ``jax.checkpoint``: the backward recomputes the
stack's activations and its kernels' residuals from the stack's input
instead of keeping them.  The frontends, the video CNN, the fusion and the
decoder stay outside the region.  The recompute replays the region's
dropout draws from the generator state the region began with, then leaves
the generator where the forward left it (``_remat_replay``), so the remat
step's draws, loss and gradients are those of the step without it.

Layouts: frontends batch-major [B, T, D]; the recurrent core time-major
[T, B, D]; decoder memories batch-major [B, S, H].
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from avsr_tpu_torch.configs import ExperimentConfig
from avsr_tpu_torch.models import decoder as dec
from avsr_tpu_torch.models import encoder as enc
from avsr_tpu_torch.models import fusion as fus
from avsr_tpu_torch.models import video_cnn
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.ops import noise as noise_ops
from avsr_tpu_torch.ops.audio_features import logmel_frontend
from avsr_tpu_torch.ops.specaugment import spec_augment
from avsr_tpu_torch.utils.numerics import compute_dtype_of, full_precision
from avsr_tpu_torch.utils.params import Params


class Batch(NamedTuple):
    """One padded batch; the modalities an architecture does not read are
    None (video* for audio-only runs)."""

    audio: Optional[torch.Tensor] = None           # [B, S] float32 waveform, or int16 PCM
    audio_lengths: Optional[torch.Tensor] = None   # [B] samples
    video: Optional[torch.Tensor] = None           # [B, T_v, H, W, C] float32 or uint8
                                                   # pixels, or [B, T_v, au_dim] float32
    video_lengths: Optional[torch.Tensor] = None   # [B] frames
    targets: Optional[torch.Tensor] = None         # [B, K] unit ids incl. EOS
    target_lengths: Optional[torch.Tensor] = None  # [B] incl. EOS
    au_targets: Optional[torch.Tensor] = None      # [B, T_a, au_dim], frontend rate
    au_row_weights: Optional[torch.Tensor] = None  # [B] 1.0 = row feeds the AU loss
    uid_hashes: Optional[torch.Tensor] = None      # [B] crc32(uid), on the host: the
                                                   # eval noise draws' keys


class EncodeOutput(NamedTuple):
    memories: Tuple[attn.AttentionMemory, ...]
    aux: Dict[str, Any]


ARCHITECTURES = ("audio", "video", "av_align", "bimodal")
# (fusion_type, decoder_type) structures of architecture="av_align" the port runs
SUPPORTED = (("cross_attention", "transformer"), ("av_align", "rnn"))


def _check_supported(cfg: ExperimentConfig) -> None:
    if cfg.architecture not in ARCHITECTURES:
        raise ValueError(f"unknown architecture {cfg.architecture!r}")
    pair = (cfg.fusion.fusion_type, cfg.decoder.decoder_type)
    if cfg.architecture == "av_align" and pair not in SUPPORTED:
        raise ValueError(
            "the port covers architecture='av_align' with cross-attention fusion and the "
            "transformer decoder, or AV-Align fusion and the RNN decoder (got "
            f"{cfg.architecture!r} / {pair})")


def uses_audio(cfg: ExperimentConfig) -> bool:
    return cfg.architecture in ("audio", "av_align", "bimodal")


def uses_video(cfg: ExperimentConfig) -> bool:
    return cfg.architecture in ("video", "av_align", "bimodal")


def memory_dims_of(cfg: ExperimentConfig) -> List[int]:
    _check_supported(cfg)
    audio_out = enc.encoder_output_dim(cfg.audio_encoder)
    video_out = enc.encoder_output_dim(cfg.video_encoder)
    if cfg.architecture == "audio":
        return [audio_out]
    if cfg.architecture == "video":
        return [video_out]
    if cfg.architecture == "bimodal":
        return [audio_out, video_out]
    # the fused memory's audio half: the encoder output (cross attention) or
    # the fusion LSTM's state (AV-Align)
    audio_half = (audio_out if cfg.fusion.fusion_type == "cross_attention"
                  else cfg.audio_encoder.hidden_units[-1])
    return [audio_half + (cfg.fusion.memory_value_dim or video_out)]


def model_init(cfg: ExperimentConfig, vocab_size: int, generator: torch.Generator,
               device="cuda") -> Params:
    """Random parameters with the reference tree's keys, shapes and
    distributions (``avsr_tpu/models/seq2seq.py:model_init``)."""
    _check_supported(cfg)
    g = generator
    params: Params = {}
    if uses_audio(cfg):
        params["audio_encoder"] = enc.encoder_init(g, cfg.audio_encoder, cfg.audio.output_dim,
                                                   device)
    if uses_video(cfg):
        params["video_frontend"] = video_cnn.video_cnn_init(g, cfg.video, device)
        params["video_encoder"] = enc.encoder_init(g, cfg.video_encoder,
                                                   cfg.video.embedding_dim, device)
    if cfg.architecture == "av_align":
        audio_out = enc.encoder_output_dim(cfg.audio_encoder)
        video_out = enc.encoder_output_dim(cfg.video_encoder)
        if cfg.fusion.fusion_type == "cross_attention":
            params["fusion"] = fus.cross_attention_fusion_init(g, cfg.fusion, audio_out,
                                                               video_out, device)
        else:
            params["fusion"] = fus.av_align_init(g, cfg.fusion, audio_out,
                                                 cfg.audio_encoder.hidden_units[-1], video_out,
                                                 device)
    params["decoder"] = dec.decoder_init(g, cfg.decoder, memory_dims_of(cfg), vocab_size, device)
    return params


def prep(dec_cfg, params: Params, idx: int, memory, lengths, cdt) -> attn.AttentionMemory:
    """The transformer decoder's memories are value-only; the RNN decoder's
    carry the keys of its attention type."""
    att_type = ("value_only" if dec_cfg.decoder_type == "transformer"
                else dec_cfg.attention_type)
    return attn.prepare_memory(att_type, params["decoder"]["atts"][idx], memory, lengths, cdt)


def _noisy_waveform(cfg: ExperimentConfig, batch: Batch, wav: torch.Tensor, train: bool,
                    generator, noise_bank, eval_snr) -> torch.Tensor:
    """Training mixes a random (type, row, offset, SNR) per example when
    ``cfg.noise.enabled``; evaluation mixes the fixed condition whenever
    ``cfg.noise.eval_snr_db`` is set, independent of ``enabled`` (a clean-
    trained model is evaluated under noise), at ``eval_snr`` when given (a
    float or 0-d tensor: one SNR of a (type x SNR) matrix)."""
    if noise_bank is None:
        return wav
    if train and cfg.noise.enabled:
        return noise_ops.sample_and_mix(generator, wav, batch.audio_lengths, noise_bank,
                                        cfg.noise.snr_db, cfg.noise.clean_probability)
    if not train and cfg.noise.eval_snr_db is not None:
        bank = noise_ops.NoiseBank.create(noise_bank, device=wav.device)
        ntype = cfg.noise.eval_noise_type if bank.num_types > 1 else None
        snr = eval_snr if eval_snr is not None else cfg.noise.eval_snr_db
        return noise_ops.mix_fixed_snr(wav, batch.audio_lengths, bank, snr, noise_type=ntype,
                                       uid_hashes=batch.uid_hashes)
    return wav


def _remat_replay(generator: torch.Generator):
    """``context_fn`` of a checkpointed region drawing from ``generator``:
    ``torch.utils.checkpoint`` restores the global RNG states around its
    recompute, not an explicit generator's.  The recompute context sets the
    generator to the state it had when the region began, so the recompute
    draws the forward's masks, and on exit puts back the state it found,
    so no later draw moves."""
    entry = generator.get_state()

    @contextlib.contextmanager
    def replay():
        found = generator.get_state()
        generator.set_state(entry)
        try:
            yield
        finally:
            generator.set_state(found)

    return contextlib.nullcontext(), replay()


def _encoder_apply(params: Params, ecfg, x_tbd, lengths, cdt, *, train: bool, remat: bool,
                   generator: Optional[torch.Generator]):
    """``enc.encoder_apply``, under ``torch.utils.checkpoint`` with
    ``remat`` in train mode (the reference's ``jax.checkpoint`` of its
    ``enc_apply``)."""
    def run(p, x):
        return enc.encoder_apply(p, ecfg, x, lengths, cdt, train=train, generator=generator)

    if not (train and remat):
        return run(params, x_tbd)
    kwargs = {} if generator is None else {"context_fn": lambda: _remat_replay(generator)}
    return checkpoint(run, params, x_tbd, use_reentrant=False, **kwargs)


def encode(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool = False,
           generator: Optional[torch.Generator] = None,
           noise_bank=None, eval_snr=None) -> EncodeOutput:
    """Batch -> prepared decoder memories.  ``train`` mixes noise (when
    ``cfg.noise.enabled`` and a bank is given) and applies the encoders'
    dropout, both drawn from ``generator``, with each encoder stack
    rematerialised under ``cfg.train.remat``; evaluation mixes the fixed
    condition of ``cfg.noise`` (``eval_snr`` over ``eval_snr_db``)."""
    _check_supported(cfg)
    with full_precision(compute_dtype_of(cfg)):
        return _encode(params, cfg, batch, train=train, generator=generator,
                       noise_bank=noise_bank, eval_snr=eval_snr)


def _encode(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool,
            generator: Optional[torch.Generator], noise_bank, eval_snr) -> EncodeOutput:
    arch = cfg.architecture
    remat = cfg.train.remat
    cdt = compute_dtype_of(cfg)
    aux: Dict[str, Any] = {}

    if uses_audio(cfg):
        wav = batch.audio
        if wav.dtype == torch.int16:
            wav = wav.float() / 32767.0  # compact-transfer PCM
        wav = _noisy_waveform(cfg, batch, wav, train, generator, noise_bank, eval_snr)
        feats, feat_len = logmel_frontend(wav, batch.audio_lengths, cfg.audio, cdt=cdt)
        if train and cfg.audio.spec_augment and generator is not None:
            a = cfg.audio
            feats = spec_augment(generator, feats, feat_len, num_time_masks=a.time_masks,
                                 time_mask_width=a.time_mask_width,
                                 num_freq_masks=a.freq_masks, freq_mask_width=a.freq_mask_width)
        aux["audio_frontend_lengths"] = feat_len

    if uses_video(cfg):
        video = batch.video
        if video.dtype == torch.uint8:
            video = video.float() / 255.0  # compact-transfer ROI crops
        v_emb, v_len = video_cnn.video_cnn_apply(
            params["video_frontend"], cfg.video, video, batch.video_lengths, cdt)

    if uses_audio(cfg):
        audio_out_tb, _ = _encoder_apply(
            params["audio_encoder"], cfg.audio_encoder, feats.transpose(0, 1), feat_len, cdt,
            train=train, remat=remat, generator=generator)
        audio_mem_len = enc.encoder_output_lengths(cfg.audio_encoder, feat_len)
        aux["audio_feature_lengths"] = audio_mem_len
    if uses_video(cfg):
        v_out_tb, _ = _encoder_apply(
            params["video_encoder"], cfg.video_encoder, v_emb.transpose(0, 1), v_len, cdt,
            train=train, remat=remat, generator=generator)
        video_mem_len = enc.encoder_output_lengths(cfg.video_encoder, v_len)

    dc = cfg.decoder
    if arch == "audio":
        mems = (prep(dc, params, 0, audio_out_tb.transpose(0, 1), audio_mem_len, cdt),)
    elif arch == "video":
        mems = (prep(dc, params, 0, v_out_tb.transpose(0, 1), video_mem_len, cdt),)
    elif arch == "bimodal":
        mems = (prep(dc, params, 0, audio_out_tb.transpose(0, 1), audio_mem_len, cdt),
                prep(dc, params, 1, v_out_tb.transpose(0, 1), video_mem_len, cdt))
    else:
        fusion_apply = (fus.cross_attention_fusion_apply
                        if cfg.fusion.fusion_type == "cross_attention" else fus.av_align_apply)
        out = fusion_apply(params["fusion"], cfg.fusion, audio_out_tb, audio_mem_len,
                           v_out_tb.transpose(0, 1), video_mem_len, cdt)
        aux["av_alignments"] = out.alignments
        aux["au_predictions"] = out.au_predictions
        mems = (prep(dc, params, 0, out.fused.transpose(0, 1), audio_mem_len, cdt),)
    return EncodeOutput(memories=mems, aux=aux)


def forward(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool = False,
            generator: Optional[torch.Generator] = None, noise_bank=None,
            sampling_p: Optional[float] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced logits for the batch: [B, K, V] fp32, and encode's aux.
    ``sampling_p`` overrides the config's scheduled-sampling probability in
    train mode (the train step's ramp); eval mode samples nothing."""
    out = encode(params, cfg, batch, train=train, generator=generator, noise_bank=noise_bank)
    if not train:
        p = 0.0
    elif sampling_p is not None:
        p = float(sampling_p)
    else:
        p = cfg.decoder.sampling_probability
    cdt = compute_dtype_of(cfg)
    with full_precision(cdt):
        logits = dec.teacher_forced_logits(
            params["decoder"], cfg.decoder, batch.targets, batch.target_lengths, out.memories,
            cdt, generator=generator, dropout=train, sampling_probability=p)
    return logits, out.aux


def loss_fn(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool = True,
            generator: Optional[torch.Generator] = None, noise_bank=None,
            sampling_p: Optional[float] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(total loss, {"ce_loss", "au_loss" (when the AU head and targets
    are present), "loss"})."""
    logits, aux = forward(params, cfg, batch, train=train, generator=generator,
                          noise_bank=noise_bank, sampling_p=sampling_p)
    return _losses(cfg, batch, logits, aux, train=train)


def loss_given_encode(params: Params, cfg: ExperimentConfig, batch: Batch,
                      enc_out: EncodeOutput, *, train: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The CE (+AU) loss from an encode already made: one eval pass shares
    the encoder between the teacher-forced loss and the beam or greedy
    decode (``avsr_tpu/models/seq2seq.py:loss_given_encode``)."""
    p = cfg.decoder.sampling_probability if train else 0.0
    cdt = compute_dtype_of(cfg)
    with full_precision(cdt):
        logits = dec.teacher_forced_logits(
            params["decoder"], cfg.decoder, batch.targets, batch.target_lengths,
            enc_out.memories, cdt, generator=generator, dropout=train, sampling_probability=p)
    return _losses(cfg, batch, logits, enc_out.aux, train=train)


def _pool_time(x_tbd: torch.Tensor, lengths: torch.Tensor, r: int) -> torch.Tensor:
    """Masked mean over groups of ``r`` consecutive time-major frames:
    [T, B, D] -> [ceil(T/r), B, D]; frames beyond each example's length
    are left out of their group's denominator."""
    T, B, D = x_tbd.shape
    Tp = -(-T // r) * r
    if Tp != T:
        x_tbd = torch.nn.functional.pad(x_tbd, (0, 0, 0, 0, 0, Tp - T))
    valid = (torch.arange(Tp, device=x_tbd.device)[:, None] < lengths[None, :]).to(x_tbd.dtype)
    groups = x_tbd.reshape(Tp // r, r, B, D)
    v = valid.reshape(Tp // r, r, B, 1)
    return (groups * v).sum(dim=1) / torch.clamp(v.sum(dim=1), min=1.0)


def _losses(cfg: ExperimentConfig, batch: Batch, logits: torch.Tensor, aux: Dict[str, Any], *,
            train: bool) -> Tuple[torch.Tensor, Dict[str, Any]]:
    ce = dec.sequence_loss(logits, batch.targets, batch.target_lengths,
                           label_smoothing=cfg.train.label_smoothing if train else 0.0)
    metrics: Dict[str, Any] = {"ce_loss": ce}
    total = ce
    if (cfg.architecture == "av_align" and cfg.fusion.au_loss_weight > 0.0
            and aux.get("au_predictions") is not None
            and batch.au_targets is not None):
        au_t = batch.au_targets.transpose(0, 1)  # time-major
        R = enc.total_time_reduction(cfg.audio_encoder)
        if R > 1:
            # predictions run at the encoder-output rate; pool the
            # frontend-rate targets to match
            au_t = _pool_time(au_t, aux["audio_frontend_lengths"], R)
        au_loss = fus.au_regression_loss(aux["au_predictions"], au_t,
                                         aux["audio_feature_lengths"],
                                         row_weights=batch.au_row_weights)
        metrics["au_loss"] = au_loss
        total = total + cfg.fusion.au_loss_weight * au_loss
    metrics["loss"] = total
    return total, metrics


def batch_to_device(arrays: Dict[str, Any], device) -> Batch:
    """Host numpy arrays (as a Predictor or a loader assembles them) ->
    device Batch: on a CUDA device each array from pinned host memory,
    copied without blocking the host.  The fields absent from ``arrays``
    stay None, other keys are ignored, and ``uid_hashes`` (the host's eval
    noise keys) stays on the host as int64."""
    dev = torch.device(device)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    t = {k: put(v) for k, v in arrays.items()
         if k in Batch._fields and k != "uid_hashes" and v is not None}
    if arrays.get("uid_hashes") is not None:
        t["uid_hashes"] = torch.from_numpy(np.asarray(arrays["uid_hashes"]).astype(np.int64))
    return Batch(**{k: t.get(k) for k in Batch._fields})

"""Typed configuration of the port: a copy of ``avsr_tpu/configs.py``.

Every dataclass, field, default, (de)serialization helper and preset of
``PRESETS`` is the JAX package's, so one config dict builds the same
experiment in both packages (``tests/test_torch_port_hygiene.py`` holds the
two copies equal).  The port keeps its own copy so that it imports nothing
of ``avsr_tpu``.  Field comments name the JAX modules that read them; the
long preset docstrings are cut to a line that points at the original.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

Architecture = str  # "audio" | "video" | "av_align" | "bimodal"


@dataclass(frozen=True)
class AudioFrontendConfig:
    """Waveform -> log-mel (or spectrogram) features, in-graph.

    Mirrors the reference's in-graph tf.signal pipeline
    (upstream:avsr/audio.py, SURVEY.md §2.2 row 8): STFT -> mel filterbank ->
    log, then frame stacking and delta features.
    """

    sample_rate: int = 16_000
    frame_length_ms: float = 25.0
    frame_step_ms: float = 10.0
    fft_length: int = 512
    num_mel_bins: int = 30
    mel_lower_hz: float = 80.0
    mel_upper_hz: float = 7_600.0
    feature_type: str = "logmel"  # "logmel" | "spectrogram"
    # Stack this many consecutive frames into each feature vector (>=1).
    frame_stacking: int = 8
    # Hop between stacked frames (downsampling factor after stacking).
    frame_skipping: int = 3
    # Append delta / delta-delta coefficients computed before stacking.
    add_deltas: bool = True
    delta_window: int = 2
    # Per-feature normalization: "none" | "global" | "per_utterance"
    normalization: str = "per_utterance"
    # Floor used inside log(mel + eps).
    log_floor: float = 1e-6
    # Compute the windowed rFFT as two MXU matmuls instead of XLA's FFT
    # (faster on TPU at speech frame sizes; numerically pinned in tests).
    use_matmul_dft: bool = True
    # Opt-in SpecAugment on the post-frontend features (training only;
    # extension beyond the reference — ops/specaugment.py).
    spec_augment: bool = False
    time_masks: int = 2
    time_mask_width: int = 20
    freq_masks: int = 2
    freq_mask_width: int = 8

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_step(self) -> int:
        return int(self.sample_rate * self.frame_step_ms / 1000.0)

    @property
    def base_dim(self) -> int:
        if self.feature_type == "spectrogram":
            d = self.fft_length // 2 + 1
        else:
            d = self.num_mel_bins
        if self.add_deltas:
            d *= 3
        return d

    @property
    def output_dim(self) -> int:
        return self.base_dim * self.frame_stacking


@dataclass(frozen=True)
class VideoFrontendConfig:
    """Per-frame CNN over lip-ROI crops (upstream:avsr/video.py, SURVEY §2.2 row 9)."""

    roi_height: int = 36
    roi_width: int = 36
    channels: int = 1
    # Conv stack: (out_channels, kernel, stride) per layer.
    conv_channels: Tuple[int, ...] = (8, 16, 32)
    conv_kernel: int = 3
    conv_stride: int = 2
    embedding_dim: int = 128
    # Alternative visual-feature path: precomputed OpenFace action units
    # (TASLP-2020 variant).  When set, the CNN is bypassed and AU feature
    # vectors are consumed directly.
    use_au_features: bool = False
    au_dim: int = 2  # AU intensity vector size when use_au_features


@dataclass(frozen=True)
class EncoderConfig:
    """Stacked (Bi)LSTM encoder (upstream:avsr/encoder.py, SURVEY §2.2 row 3)."""

    cell_type: str = "lstm"  # "lstm" | "gru"
    hidden_units: Tuple[int, ...] = (256, 256, 256)
    bidirectional: bool = True
    dropout_rate: float = 0.1  # per-layer output dropout, train only
    recurrent_dropout_rate: float = 0.0
    # residual connections between stacked layers where dims match
    residual: bool = False
    # highway wrapper between stacked layers where dims match:
    # y = t*h + (1-t)*x with a learned transform gate t = sigmoid(x W + b)
    highway: bool = False
    layer_norm: bool = False
    # lax.scan unroll factor (trades compile time/code size for fewer
    # sequential loop iterations on TPU)
    scan_unroll: int = 1
    # Encoder family: "rnn" (reference parity, the stacked (Bi)LSTM/GRU
    # above) or "transformer" (opt-in extension, models/transformer.py:
    # pre-LN self-attention stack — hidden_units must all equal d_model,
    # depth = len(hidden_units); no sequential scan, MXU-dense).  The
    # RNN-stack knobs (cell_type, bidirectional, residual, highway,
    # layer_norm, recurrent_dropout_rate, scan_unroll) apply to "rnn" only.
    encoder_type: str = "rnn"
    # Transformer-only knobs.
    num_heads: int = 4
    ff_multiplier: int = 4
    # Conformer-style convolution module (arXiv:2005.08100; transformer
    # encoders only): odd kernel width of a masked depthwise time-conv
    # block (pre-LN -> pointwise GLU -> depthwise conv -> LN + swish ->
    # pointwise, residual) inserted between each layer's self-attention
    # and feed-forward blocks.  Restores the LOCAL inductive bias the
    # recurrent encoders have and pure self-attention lacks — the
    # measured source of the v2 family's held-out CER gap (RESULTS.md
    # round-4 campaign).  None = plain transformer.
    conv_kernel: Optional[int] = None
    # Pyramidal time reduction (Listen-Attend-Spell, arXiv:1508.01211; NOT
    # in the reference — opt-in extension): one factor per layer, applied
    # to that layer's INPUT by concatenating r consecutive frames
    # ([T, B, D] -> [ceil(T/r), B, r*D]).  E.g. (1, 2, 2) quarters the top
    # layer's step count — and with it every downstream scan over audio
    # steps (fusion, decoder memory), the measured latency bounds of the
    # train step (RESULTS.md).  None = no reduction (reference parity).
    time_reduction: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class FusionConfig:
    """AV-Align cross-modal attention (arXiv:1809.01728; SURVEY §2.2 row 4).

    The top audio-encoder LSTM attends over video-encoder outputs at every
    audio timestep; the attended visual context is concatenated with the audio
    state to form the decoder memory.  The TASLP-2020 variant adds an
    action-unit regression head on the attended context.
    """

    attention_type: str = "bahdanau"  # "bahdanau" | "luong"
    attention_units: int = 128
    # Auxiliary AU-regression loss weight (0 disables; TASLP-2020 uses > 0).
    au_loss_weight: float = 0.0
    au_dim: int = 2
    # Feed the attended context into the next audio-LSTM step input
    # (input feeding), matching AttentionWrapper semantics.
    input_feeding: bool = True
    # Learned down-projection of the attention VALUES (video memory) to this
    # dim before the fusion scan (None = identity, reference parity).  The
    # fusion scan is HBM-bandwidth-bound on re-reading values every step
    # (RESULTS.md round-2 floor analysis) — streaming fewer bytes is the
    # only remaining speedup; changes the model (context dim = value dim).
    memory_value_dim: Optional[int] = None
    # Fusion family: "av_align" (reference mechanism — the recurrent scan
    # above) or "cross_attention" (opt-in extension, models/fusion.py
    # cross_attention_fusion_apply: scan-free multi-head cross-attention,
    # audio queries over video keys/values in a few large MXU matmuls;
    # pairs with encoder_type="transformer" for a fully scan-free encode
    # path).  attention_units = per-head query/key dim there;
    # input_feeding applies to "av_align" only; memory_value_dim sets the
    # attended-context dim for both.
    fusion_type: str = "av_align"
    num_heads: int = 4


@dataclass(frozen=True)
class DecoderConfig:
    """Attention character decoder (upstream:avsr/decoder_unimodal.py, §2.2 row 5)."""

    embedding_dim: int = 128
    hidden_units: Tuple[int, ...] = (256,)
    attention_type: str = "bahdanau"  # "bahdanau" | "luong"
    attention_units: int = 128
    dropout_rate: float = 0.1
    # Scheduled sampling probability: probability of feeding the model's own
    # sampled prediction instead of the gold token at each step (0 = pure
    # teacher forcing, 1 = free running).
    sampling_probability: float = 0.0
    # Linear ramp of the sampling probability from 0 to
    # ``sampling_probability`` over this many optimizer steps (the classic
    # scheduled-sampling curriculum).  0 = constant probability.  The ramp
    # is computed ON DEVICE from the train state's step counter, so one
    # compiled program serves the whole schedule — no per-epoch recompiles
    # (same pattern as the runtime-SNR eval programs).
    sampling_ramp_steps: int = 0
    # Maximum label length (static decode horizon).  The bimodal decoder
    # (upstream:avsr/decoder_bimodal.py, §2.2 row 6) needs no knob here:
    # architecture="bimodal" hands the decoder two attention memories and it
    # builds one attention mechanism per memory (dual attention).
    max_label_length: int = 150
    # Learned down-projection of each attention memory's VALUES to this dim
    # (None = identity, reference parity).  Decode/teacher-forcing steps
    # re-read the values every step (bandwidth floor) — smaller values
    # stream fewer bytes; changes the model (context dim = value dim).
    memory_value_dim: Optional[int] = None
    # Decoder family: "rnn" (reference parity — the attention LSTM above)
    # or "transformer" (opt-in extension, models/transformer_decoder.py:
    # causal self-attention + per-memory cross-attention; teacher forcing
    # runs ALL label positions in parallel — no scan — and decode carries
    # KV caches through the same greedy/beam engines).  hidden_units must
    # all equal d_model; scheduled sampling is rejected (sequential by
    # nature); every attention-memory dim (or memory_value_dim) must be
    # divisible by num_heads.
    decoder_type: str = "rnn"
    num_heads: int = 4
    ff_multiplier: int = 4


@dataclass(frozen=True)
class NoiseConfig:
    """SNR-controlled additive-noise robustness training (SURVEY §5.9).

    The reference mixed babble/cafe noise into fixed noisy TFRecord copies at
    dataset-writing time; this framework mixes ON DEVICE inside the jitted
    step, sampling a noise segment and SNR per example.
    """

    enabled: bool = False
    # Named noise types to draw from during training.  Applies when the
    # noise bank is TYPED (built from a {type: waveforms} mapping): the bank
    # is filtered to these names (unknown names fail loudly).  A plain-array
    # bank has one anonymous type and ignores this.
    noise_types: Tuple[str, ...] = ("babble", "cafe")
    # Training SNRs sampled uniformly from this set; "clean" is encoded as
    # +inf handled via probability below.
    snr_db: Tuple[float, ...] = (-5.0, 0.0, 10.0, 20.0)
    # Probability an example is left clean during training.
    clean_probability: float = 0.2
    # Fixed (type x SNR) condition for deterministic evaluation
    # (eval_snr_db None = clean eval; eval_noise_type is used only when the
    # bank has more than one type).
    eval_snr_db: Optional[float] = None
    eval_noise_type: str = "babble"
    # TFRecord noise-bank sources as ((type_name, path), ...) pairs — the
    # config-file/CLI route to a typed bank (AVSR's noise_bank_record kwarg
    # is the in-code route):
    #   --set 'noise.bank_records=[["babble","b.tfrecord"],["cafe","c.tfrecord"]]'
    bank_records: Optional[Tuple[Tuple[str, str], ...]] = None


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline (upstream:avsr/io_utils.py, SURVEY §2.2 row 10)."""

    unit: str = "character"  # "character" | "character_lrs2" | "phoneme" | "viseme"
    unit_file: Optional[str] = None  # path to symbol table; None = builtin
    # Fail on transcripts containing out-of-inventory units instead of
    # silently dropping them (dropped symbols in references fake better
    # error rates); off by default for reference parity.
    strict_units: bool = False
    audio_train_records: Optional[str] = None
    audio_eval_records: Optional[str] = None
    video_train_records: Optional[str] = None
    video_eval_records: Optional[str] = None
    batch_size: int = 32
    # Static-shape length bucketing: audio-frame bucket boundaries.  Each
    # batch is padded to its bucket's (T_audio, T_video, label_len) maxima.
    audio_bucket_boundaries: Tuple[int, ...] = (200, 400, 800, 1200, 1600)
    # Optional per-bucket label-length caps (same length as the boundaries).
    # Short-utterance buckets then run a SHORTER decoder scan — the decoder
    # horizon is the second-largest sequential axis, so capping it buys real
    # step time on short buckets.  None = every bucket pads labels to
    # max_label_length (reference behavior).  Labels longer than the cap are
    # truncated, exactly as max_label_length already truncates.
    label_bucket_caps: Optional[Tuple[int, ...]] = None
    # Optional per-bucket batch sizes (same length as the boundaries).
    # Short buckets amortize fixed scan latency over more examples, and the
    # longest buckets can shrink below batch_size to stay inside the HBM
    # working set (the 10 s bucket measured SUPERLINEAR step cost at B=128
    # — RESULTS.md round 3).  None = batch_size for every bucket.
    bucket_batch_sizes: Optional[Tuple[int, ...]] = None
    # Per-bucket gradient-accumulation factors (len == number of buckets);
    # each must divide that bucket's batch size.  Lets long buckets run at
    # their throughput-optimal micro-batch (bucket_batch_sizes) while
    # keeping a constant EFFECTIVE batch across the mix.  Overrides
    # train.grad_accum_steps per bucket; None = use the global knob.
    bucket_grad_accum: Optional[Tuple[int, ...]] = None
    video_fps: float = 25.0
    max_audio_seconds: float = 16.0
    max_label_length: int = 150
    # host-side parallel parse workers for the grain-backed loader
    # (data/grain_loader.py); the default loader is single-threaded + a
    # prefetch thread, which saturates this model scale.
    num_workers: int = 0
    # Host->device transfer encoding.  "compact" ships audio as int16
    # (waveform x 32767 — bit-exact for data that originated as 16-bit PCM,
    # i.e. every real corpus) and lip-ROI video as uint8 (round(v*255),
    # matching the TFRecord uint8 codec), dequantized on device inside the
    # jitted step.  ~3x fewer H2D bytes per batch; the AU-feature video path
    # and all lengths/targets stay as-is.  "float32" = no recoding.
    transfer_dtype: str = "float32"  # "float32" | "compact"
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + loop (upstream:avsr/avsr.py train path, SURVEY §2.2 rows 1-2)."""

    learning_rate: float = 1e-3
    lr_decay: float = 0.0  # exponential decay rate per epoch (0 = constant)
    lr_schedule: str = "constant"  # "constant" | "exponential" | "cosine" | "warmup_cosine"
    warmup_steps: int = 0
    optimizer: str = "adam"  # "adam" | "adamw" | "sgd" | "lamb"
    max_gradient_norm: float = 1.0  # clip_by_global_norm
    weight_decay: float = 0.0
    label_smoothing: float = 0.0
    num_epochs: int = 100
    # Mixed precision: bf16 matmul/activations with fp32 params + state.
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    # Pre-compile every bucket's train program before epoch 1 (one dummy
    # step per bucket on a throwaway state copy; results are bit-identical
    # either way).  On TPU each new bucket otherwise stalls mid-epoch for
    # minutes of compile.
    warmup_compile: bool = False
    # Rematerialization policy for the encoder/decoder scans.
    remat: bool = False
    # AV regimes: batch same-depth audio/video encoder layers into single
    # scans (rnn.multi_fused_bilstm_scan).  Numerically identical either way
    # (tested) but MEASURED SLOWER on v5e at the flagship shape (49.0 vs
    # 47.0 ms/step, B=128: a G=4-batched gate matmul step costs ~2x a G=2
    # step there, so padding video to T_audio loses more than the removed
    # scan region saves — RESULTS.md round 3).  Off by default; the knob
    # remains for other shapes (small B / T_v ~ T_a).
    fuse_encoder_scans: bool = False
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 5
    save_every_steps: int = 0  # 0 = per-epoch only
    eval_every_epochs: int = 1
    # Stop training after this many consecutive in-train evals without a
    # CER improvement (0 = never).  The best step is tracked in
    # run_dir/best.json either way and pinned against keep-N pruning;
    # evaluate/export accept checkpoint="best".
    early_stop_patience: int = 0
    log_every_steps: int = 50
    seed: int = 42
    # Gradient accumulation (train/step.py): split every batch into this
    # many micro-batches on device (lax.scan) and apply ONE optimizer
    # update — activation memory scales with the micro-batch while the
    # effective batch, loader, and checkpoint semantics are unchanged.
    # Token-weighted accumulation keeps the CE gradient exactly equal to
    # the full-batch gradient.  Per-bucket factors:
    # data.bucket_grad_accum.
    grad_accum_steps: int = 1
    # Device mesh (parallel/mesh.py): batch axis sharded over
    # num_data_shards devices (gradient all-reduce inserted by XLA), and
    # params/optimizer tensor-parallel over num_model_shards devices
    # (Megatron-style output-dim sharding, parallel/tp.py).  Both 1 =
    # single-device.  AVSR builds the mesh from these knobs when no
    # explicit mesh is passed.
    num_data_shards: int = 1
    num_model_shards: int = 1
    # Also mirror JSONL metrics into TensorBoard scalar event files under
    # run_dir/tb (written by avsr_tpu/utils/tensorboard.py — no TF
    # dependency; point a stock TensorBoard at the run dir).
    tensorboard: bool = False


@dataclass(frozen=True)
class DecodeConfig:
    """Beam / greedy decoding (SURVEY §3.2)."""

    beam_width: int = 10
    length_penalty: float = 0.0  # Google-NMT length normalization alpha
    max_decode_length: int = 150


@dataclass(frozen=True)
class ExperimentConfig:
    """One experiment = the full knob set of the reference's AVSR constructor."""

    architecture: Architecture = "audio"  # audio | video | av_align | bimodal
    audio: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    video: VideoFrontendConfig = field(default_factory=VideoFrontendConfig)
    audio_encoder: EncoderConfig = field(default_factory=EncoderConfig)
    video_encoder: EncoderConfig = field(
        default_factory=lambda: EncoderConfig(hidden_units=(256,))
    )
    fusion: FusionConfig = field(default_factory=FusionConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    name: str = "experiment"

    # ---- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        return _dataclass_from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def override(self, dotted: dict) -> "ExperimentConfig":
        """Override leaves by dotted path, e.g. {"train.learning_rate": 3e-4}."""
        d = self.to_dict()
        for key, value in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key: {key}")
            node[leaf] = value
        return ExperimentConfig.from_dict(d)


def _dataclass_from_dict(cls: type, d: dict) -> Any:
    if not dataclasses.is_dataclass(cls):
        return d
    # Unknown keys fail loudly: a typo in a --config JSON file
    # ("learing_rate") silently training with the default would be an
    # experiment run with the wrong hyperparameters and no error.
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(
            f"unknown config key(s) for {cls.__name__}: "
            f"{sorted(unknown)} (known: {sorted(known)})"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            v = _dataclass_from_dict(f.type, v)
        elif isinstance(f.type, str):
            # Deferred annotations: resolve the few nested dataclasses by name.
            nested = _NESTED.get(f.type)
            if nested is not None and isinstance(v, dict):
                v = _dataclass_from_dict(nested, v)
        if isinstance(v, list):
            v = _deep_tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _deep_tuple(v: Any) -> Any:
    """Lists (from JSON) -> tuples, recursively: configs must stay hashable
    (they key the jitted-program caches), incl. nested pairs like
    noise.bank_records."""
    if isinstance(v, list):
        return tuple(_deep_tuple(x) for x in v)
    return v


_NESTED = {
    "AudioFrontendConfig": AudioFrontendConfig,
    "VideoFrontendConfig": VideoFrontendConfig,
    "EncoderConfig": EncoderConfig,
    "FusionConfig": FusionConfig,
    "DecoderConfig": DecoderConfig,
    "NoiseConfig": NoiseConfig,
    "DataConfig": DataConfig,
    "TrainConfig": TrainConfig,
    "DecodeConfig": DecodeConfig,
}


# ---------------------------------------------------------------------------
# Canned experiment configs matching the reference regimes
# [BASELINE.json:configs].
# ---------------------------------------------------------------------------


def audio_only_tcdtimit() -> ExperimentConfig:
    """Audio-only: log-mel -> BiLSTM encoder -> attention char decoder."""
    return ExperimentConfig(architecture="audio", name="audio_tcdtimit")


def video_only_tcdtimit() -> ExperimentConfig:
    """Visual-only lip-reading: lip-ROI CNN -> seq2seq decoder."""
    return ExperimentConfig(architecture="video", name="video_tcdtimit")


def av_align_tcdtimit() -> ExperimentConfig:
    """AV-Align cross-modal attention between audio and video encoders."""
    return ExperimentConfig(architecture="av_align", name="av_align_tcdtimit")


def bimodal_tcdtimit() -> ExperimentConfig:
    """Bimodal-decoder baseline: decoder attends to audio AND video memories
    with two attention mechanisms (upstream decoder_bimodal.py)."""
    return ExperimentConfig(architecture="bimodal", name="bimodal_tcdtimit")


def av_align_noisy() -> ExperimentConfig:
    """Noise-robust AV training: babble/cafe at {-5,0,10,20} dB with AV-Align."""
    return ExperimentConfig(
        architecture="av_align",
        noise=NoiseConfig(enabled=True),
        name="av_align_noisy",
    )


def lrs2_full() -> ExperimentConfig:
    """Full LRS2 pipeline (``avsr_tpu/configs.py:lrs2_full``: the measured
    bucket geometry and its reasons are documented there)."""
    return ExperimentConfig(
        architecture="av_align",
        decoder=DecoderConfig(sampling_probability=0.1, max_label_length=150),
        fusion=FusionConfig(au_loss_weight=10.0),
        decode=DecodeConfig(beam_width=10),
        # LRS2 transcripts contain digits/punctuation the base charset lacks.
        # compact transfer: LRS2 audio is 16-bit PCM and ROI crops are uint8
        # pixels, so int16/uint8 H2D is bit-exact and ~3x fewer bytes/batch.
        data=DataConfig(
            unit="character_lrs2", transfer_dtype="compact",
            batch_size=128,
            audio_bucket_boundaries=(200, 400, 600, 1000, 1600),
            label_bucket_caps=(30, 55, 80, 130, 150),
            bucket_batch_sizes=(128, 128, 128, 64, 32),
        ),
        train=TrainConfig(warmup_compile=True),
        name="lrs2_av_align",
    )


def lrs2_av_v2() -> ExperimentConfig:
    """Scan-free AV family: transformer encoders, cross-attention fusion and
    the transformer decoder (``avsr_tpu/configs.py:lrs2_av_v2`` documents
    its recipe and quality status)."""
    base = lrs2_full()
    return base.replace(
        train=dataclasses.replace(
            base.train, lr_schedule="warmup_cosine", warmup_steps=400),
        audio_encoder=EncoderConfig(
            hidden_units=(512, 512, 512), encoder_type="transformer",
            num_heads=8, dropout_rate=0.1, conv_kernel=15,
        ),
        video_encoder=EncoderConfig(
            hidden_units=(512,), encoder_type="transformer", num_heads=8,
            dropout_rate=0.1, conv_kernel=15,
        ),
        fusion=FusionConfig(
            # per-head dim 128 x 4 heads = the benched v2_scanfree /
            # v2_conv arms (BENCH_variants.json; v2_conv adds this
            # preset's conv_kernel=15).  NO memory_value_dim: the
            # held-out campaign rejected the value down-projection on
            # THREE recipes — fast family (round 4), and the conv15
            # recipe at this preset's own 0.5 ratio (round 5 arm
            # av_v2_conv15_vdim: parity FAIL) — so the preset matches
            # its parity-passing gated arm (av_v2_conv15) knob for knob.
            fusion_type="cross_attention", num_heads=4, attention_units=128,
            au_loss_weight=10.0,
        ),
        decoder=DecoderConfig(
            decoder_type="transformer", hidden_units=(256,), num_heads=4,
            max_label_length=150,
        ),
        name="lrs2_av_v2",
    )


def lrs2_av_fast() -> ExperimentConfig:
    """Fast AV preset, the port's main path: the recurrent encoders with the
    (2,2,1) audio time reduction, multi-head cross-attention fusion and
    the transformer decoder (``avsr_tpu/configs.py:lrs2_av_fast``
    documents its levers and quality gates)."""
    base = lrs2_full()
    return base.replace(
        audio_encoder=dataclasses.replace(
            base.audio_encoder, time_reduction=(2, 2, 1)),
        fusion=FusionConfig(
            fusion_type="cross_attention", num_heads=4, attention_units=128,
            au_loss_weight=10.0,
        ),
        decoder=dataclasses.replace(
            base.decoder, decoder_type="transformer", num_heads=4,
            sampling_probability=0.0),
        train=dataclasses.replace(
            base.train, lr_schedule="warmup_cosine", warmup_steps=400),
        name="lrs2_av_fast",
    )


PRESETS = {
    "audio_tcdtimit": audio_only_tcdtimit,
    "video_tcdtimit": video_only_tcdtimit,
    "av_align_tcdtimit": av_align_tcdtimit,
    "bimodal_tcdtimit": bimodal_tcdtimit,
    "av_align_noisy": av_align_noisy,
    "lrs2_av_align": lrs2_full,
    "lrs2_av_v2": lrs2_av_v2,
    "lrs2_av_fast": lrs2_av_fast,
}

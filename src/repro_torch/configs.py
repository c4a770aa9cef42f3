"""Configs of the port: the architectures (DeepSpeech2, the dense LMs, the
MoE LMs, the VLM backbone, the Mamba-1 SSM, the Mamba-2 hybrid and the
whisper encoder-decoder), the FL experiment and the precision levels.

The fields and defaults are those of the JAX package's ``configs/base.py``,
``configs/deepspeech2_paper.py``, ``configs/stablelm_1p6b.py``,
``configs/qwen3_8b.py``, ``configs/deepseek_67b.py``,
``configs/qwen1p5_110b.py``, ``configs/kimi_k2_1t_a32b.py``,
``configs/arctic_480b.py``, ``configs/qwen2_vl_2b.py``,
``configs/falcon_mamba_7b.py``, ``configs/zamba2_2p7b.py`` and
``configs/whisper_tiny.py``, cut to what the federated round and the
models' training and serving paths read. Every config is a frozen dataclass,
so configs hash and compare. ``register_arch`` adds a config to
``ARCH_REGISTRY``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

# symbols per f32 scale on the uplink wire (blockwise scales)
QUANT_BLOCK = 256


@dataclass(frozen=True)
class ArchConfig:
    """The architecture fields the DeepSpeech2 model, the dense, moe, vlm,
    ssm and hybrid LM families and the audio encoder-decoder read."""

    name: str
    family: str  # "ds2" | "dense" | "moe" | "vlm" | "ssm" | "hybrid" | "audio"
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 1
    n_kv_heads: int = 1
    d_ff: int = 0
    source: str = ""
    # attention flavour
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False  # sectioned multimodal RoPE (qwen2-vl)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with the MoE branch
    router_aux_coef: float = 0.01
    # SSM (mamba1 / mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0  # 0 -> 2 * d_model
    ssm_heads: int = 0  # mamba2 heads; 0 -> d_inner // 64
    dt_rank: int = 0  # mamba1 dt projection rank; 0 -> d_model // 16
    # hybrid (zamba2): one shared attention block applied after every
    # ``attn_every`` SSM layers, the same weights at each application
    attn_every: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of audio at 50 Hz after the conv
    # modality frontend stub ("none" | "audio" | "vision")
    frontend: str = "none"
    frontend_dim: int = 0
    # sliding-window KV cache size for long-context decode
    window: int = 8192
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # recompute each block's activations in the backward pass
    # (torch.utils.checkpoint; the reference's jax.checkpoint)
    remat: bool = False
    # the reference's XLA lowering controls (a Python loop over the layers
    # either way here); accepted, and they change no result
    unroll_layers: bool = False
    unroll_attn: bool = False
    # query/key chunk of the plain chunked attention
    attn_chunk: int = 1024
    # sequence chunk of the training loss's logits
    loss_chunk: int = 512
    # route causal prefill attention through the flash kernel
    # (kernels/flash_attention.py); windowed, non-causal and differentiable
    # attention keep the chunked path
    use_flash_kernel: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.resolved_d_inner() // 64)

    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 heads, <= 4
        experts, f32."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        kw: Dict[str, Any] = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=0,
            d_inner=0,
            dt_rank=0,
            ssm_heads=0,
            window=64,
            remat=False,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.n_experts:
            kw.update(
                n_experts=min(self.n_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                moe_d_ff=min(self.moe_d_ff or self.d_ff, 256),
            )
        if self.attn_every:
            kw.update(attn_every=1, n_layers=2)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=32)
        if self.frontend != "none":
            kw.update(frontend_dim=d_model)
        if self.mrope:
            # rescale the M-RoPE sections to the reduced head_dim
            half = (d_model // n_heads) // 2
            t = max(1, half // 4)
            rest = (half - t) // 2
            kw.update(mrope_sections=(t, rest, half - t - rest))
        return self.with_(**kw)


# ---------------------------------------------------------------- input shapes


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class PrecisionLevel:
    """One selectable client precision level (see the JAX package's
    ``configs/base.py`` for the model behind each curve)."""

    bits: int

    @property
    def rel_energy(self) -> float:
        compute = (self.bits / 32.0) ** 0.9
        overhead = (self.bits / 32.0) ** 0.45
        return 0.55 * compute + 0.45 * overhead

    @property
    def rel_latency(self) -> float:
        return 0.5 * (self.bits / 32.0) + 0.5 * (self.bits / 32.0) ** 0.5

    @property
    def rel_accuracy(self) -> float:
        return {4: 0.75, 8: 0.93, 16: 0.99, 32: 1.0}[self.bits]

    @property
    def noise_sensitivity(self) -> float:
        return {4: 0.35, 8: 0.15, 16: 0.05, 32: 0.02}[self.bits]


PRECISION_LEVELS: Tuple[PrecisionLevel, ...] = tuple(
    PrecisionLevel(b) for b in (4, 8, 16, 32)
)
BITS_TO_LEVEL = {p.bits: p for p in PRECISION_LEVELS}


@dataclass(frozen=True)
class FLConfig:
    n_clients: int = 100
    clients_per_round: int = 20
    n_rounds: int = 100
    local_steps: int = 4
    local_batch: int = 8
    lr: float = 5e-4
    strategy: str = "fedavg"  # fedavg | class_equal | majority_centric
    planner: str = "rag"  # rag | unified | rag_energy
    snr_db: float = 20.0
    quant_block: int = QUANT_BLOCK
    seed: int = 0
    # physical OTA channel (core/channel.py): "ideal" is the coin-flip +
    # AWGN path; "fading" draws per-client Rayleigh gains with truncated
    # channel inversion under the transmit power budget
    channel_model: str = "ideal"  # ideal | fading
    fade_threshold: float = 0.1  # |h|^2 truncation threshold
    tx_power_budget: float = 100.0  # per-client max transmit power P
    pathloss_spread_db: float = 0.0  # log-normal shadowing std (dB)
    downlink_bits: int = 32
    downlink_block: int = QUANT_BLOCK
    # the sharded data planes (launch/mesh.make_data_mesh): the OTA fold's
    # symbol axis over this many shards, one a card on a card server (it
    # raises with fewer cards), on the CPU all on it; 0 and 1 are the
    # single-device path
    mesh_data_shards: int = 0
    dropout_prob: float = 0.0
    fedprox_mu: float = 0.0
    server_momentum: float = 0.0
    quantize_server_state: bool = False
    # paper Table II category mixture (unused by the round loops, as in
    # the reference)
    categories: Tuple[str, ...] = (
        "entertainment",
        "smart_home",
        "general_query",
        "personal_request",
    )
    category_probs: Tuple[float, ...] = (0.327, 0.160, 0.319, 0.194)


ARCH_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        ARCH_REGISTRY[name] = fn
        return fn

    return deco


@register_arch("deepspeech2")
def deepspeech2() -> ArchConfig:
    """The paper's DeepSpeech2-style ASR model: 3 bi-GRU layers of 256,
    80 mel features, a 64-symbol vocabulary (arXiv:1512.02595)."""
    return ArchConfig(
        name="deepspeech2",
        family="ds2",
        n_layers=3,
        d_model=256,
        vocab_size=64,
        frontend="audio",
        frontend_dim=80,
        source="arXiv:1512.02595",
    )


@register_arch("stablelm-1.6b")
def stablelm_1p6b() -> ArchConfig:
    """stablelm-1.6b: dense, MHA (32 heads of 64)."""
    return ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100_352,
        source="hf:stabilityai/stablelm-2-1_6b",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("qwen3-8b")
def qwen3_8b() -> ArchConfig:
    """qwen3-8b: dense, GQA (32 query heads over 8 KV heads of 128),
    qk-norm, RoPE theta 1e6, untied embeddings."""
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("deepseek-67b")
def deepseek_67b() -> ArchConfig:
    """deepseek-67b: dense llama-arch, GQA (64 query heads over 8 KV heads
    of 128)."""
    return ArchConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102_400,
        source="arXiv:2401.02954",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("qwen1.5-110b")
def qwen1p5_110b() -> ArchConfig:
    """qwen1.5-110b: dense, GQA (64 query heads over 8 KV heads of 128),
    QKV bias."""
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=49152,
        vocab_size=152_064,
        qkv_bias=True,
        source="hf:Qwen/Qwen1.5-0.5B",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("kimi-k2-1t-a32b")
def kimi_k2_1t_a32b() -> ArchConfig:
    """kimi-k2-1t-a32b: MoE, 384 experts of 2,048 (top 8), GQA (64 query
    heads over 8 KV heads of 112)."""
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        moe_d_ff=2048,
        n_experts=384,
        experts_per_token=8,
        vocab_size=163_840,
        source="arXiv:2501.kimi2",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("arctic-480b")
def arctic_480b() -> ArchConfig:
    """arctic-480b: MoE, 128 experts of 4,864 (top 2) with a dense MLP of
    4,864 in parallel, GQA (56 query heads over 8 KV heads of 128)."""
    return ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        moe_d_ff=4864,
        n_experts=128,
        experts_per_token=2,
        dense_residual=True,
        vocab_size=32_000,
        source="hf:Snowflake/snowflake-arctic-base",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("qwen2-vl-2b")
def qwen2_vl_2b() -> ArchConfig:
    """qwen2-vl-2b: the VLM's language decoder, GQA (12 query heads over 2
    KV heads of 128), QKV bias, M-RoPE over (16, 24, 24) rotary pairs. The
    vision encoder is a stub: patch embeddings of ``frontend_dim`` arrive
    precomputed and are projected and prepended to the tokens."""
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151_936,
        qkv_bias=True,
        mrope=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision",
        frontend_dim=1536,
        source="arXiv:2409.12191",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("falcon-mamba-7b")
def falcon_mamba_7b() -> ArchConfig:
    """falcon-mamba-7b: attention-free Mamba-1 (d_inner 8,192, state 16,
    dt rank 256, conv 4); each layer is one Mamba block, no MLP."""
    return ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,  # attention-free
        n_kv_heads=1,
        d_ff=0,  # no MLP: the mamba block is the whole layer
        vocab_size=65_024,
        ssm_state=16,
        ssm_conv=4,
        source="arXiv:2410.05355",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("zamba2-2.7b")
def zamba2_2p7b() -> ArchConfig:
    """zamba2-2.7b: 54 Mamba-2 layers (80 SSD heads of 64, state 64) and
    one shared attention + MLP block (32 heads of 80, d_ff 10,240) applied
    after every 6 of them."""
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32_000,
        ssm_state=64,
        ssm_conv=4,
        attn_every=6,  # the shared attention block after every 6 mamba2 layers
        source="arXiv:2411.15242",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
    )


@register_arch("whisper-tiny")
def whisper_tiny() -> ArchConfig:
    """whisper-tiny: 4 encoder layers over 1,500 frames and 4 decoder
    layers (causal self-attention and cross-attention), 6 heads of 64,
    SwiGLU MLPs of 1,536, sinusoidal positions (no RoPE). The mel and conv
    frontend is a stub: frame embeddings of ``frontend_dim`` arrive
    precomputed."""
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder layers
        encoder_layers=4,
        encoder_seq=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51_865,
        rope_theta=0.0,  # sinusoidal positions
        frontend="audio",
        frontend_dim=384,
        source="arXiv:2212.04356",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


# the repository's assigned architectures (the reference's
# ``configs/all_archs.py``)
ASSIGNED_ARCHS = (
    "kimi-k2-1t-a32b",
    "zamba2-2.7b",
    "stablelm-1.6b",
    "qwen3-8b",
    "qwen2-vl-2b",
    "deepseek-67b",
    "whisper-tiny",
    "qwen1.5-110b",
    "falcon-mamba-7b",
    "arctic-480b",
)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(ARCH_REGISTRY))

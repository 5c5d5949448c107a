"""Configuration of the LRCN model, copied from ``lrcn_tpu.config``.

The dataclass and its fields are those of the JAX package, so a
``config.json`` written by either package loads in the other.  It is a copy
and not an import because this package loads nothing of ``lrcn_tpu``: the
machine with the card has no JAX.

Mirrors the user-visible flag surface of the reference CLI
(reference: lrcn.jl:30-55, ArgParse table) as a typed dataclass, minus the
reference's dead/broken flags (``--gclip`` parsed but clipping commented out
at lrcn.jl:386-393; ``--lr`` parsed but Adam defaults used at lrcn.jl:399-405;
``:bestfile`` referenced at lrcn.jl:63 but never declared).  Here ``lr`` and
``gclip`` are real and wired into the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# fc7 feature width of VGG-16 (reference: lrcn.jl:28 `const cnnout = 4096`).
CNN_FEATURE_DIM = 4096

# Captions longer than this are skipped during training/eval
# (reference: lrcn.jl:353-355, 437-439).
MAX_CAPTION_LEN = 28


@dataclasses.dataclass
class LRCNConfig:
    """Model + training + decoding configuration.

    Defaults match the reference defaults (lrcn.jl:32-55).
    """

    # --- model (reference: lrcn.jl:39-40, initweights lrcn.jl:489-510) ---
    hidden: Sequence[int] = (1000, 1000)   # LSTM layer widths
    embed: int = 1000                      # word-embedding width
    cnn_feature_dim: int = CNN_FEATURE_DIM
    vocab_size: int = 0                    # filled in after tokenization

    # --- training (reference: lrcn.jl:41-45, train! lrcn.jl:223-246) ---
    epochs: int = 10
    batch_size: int = 25
    lr: float = 1e-3          # Adam default, matching effective ref behavior
    gclip: float = 0.0        # 0 = off, matching effective ref behavior
    dropout: float = 0.4      # hard-coded at lrcn.jl:227
    seed: int = -1            # <=0 means unseeded (reference: lrcn.jl:60)
    max_caption_len: int = MAX_CAPTION_LEN

    # --- numerics (TPU-first; no reference equivalent) ---
    # Parameters are kept in float32; matmuls run in bfloat16 on the MXU.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # --- decoding (reference: lrcn.jl:38,42,53) ---
    generate: int = 0          # max words to generate (0 = no generation)
    beam_width: int = 3
    capnumber: int = 1000      # number of captions for eval-set generation

    # --- data / io (reference: lrcn.jl:33-37,49-52) ---
    datafiles: Sequence[str] = ()
    loadfile: str | None = None
    savefile: str | None = None
    flickr: bool = False
    coco: bool = False
    image: str | None = None
    vgg_model: str | None = None   # MatConvNet .mat path (reference: lrcn.jl:34)

    # --- parallelism (TPU addition; the reference is single-GPU) ---
    mesh_shape: Sequence[int] = (1, 1)      # (data, model)
    mesh_axis_names: Sequence[str] = ("data", "model")

    def __post_init__(self):
        self.hidden = tuple(self.hidden)
        if len(self.hidden) != 2:
            raise ValueError(
                "the LRCN decoder is a factored 2-layer LSTM; got "
                f"hidden={self.hidden!r} (reference hard-codes 2 layers in "
                "its forward pass, lrcn.jl:540-551)"
            )

    @property
    def factor_dim(self) -> int:
        """Width of each half of the factored LSTM-2 input.

        Reference: lrcn.jl:504-505 — both the h1 projection and the CNN
        projection map to ``ceil(hidden2 / 2)``; their concat feeds LSTM-2.
        """
        return -(-self.hidden[1] // 2)


# the published text-model settings the decoder computes one way only:
# key -> the one value it takes (Kimi-VL-A3B's ``text_config``)
_MOE_FIXED = {"q_lora_rank": None, "n_group": 1, "topk_group": 1,
              "scoring_func": "sigmoid", "topk_method": "noaux_tc",
              "hidden_act": "silu", "rope_scaling": None,
              "attention_bias": False, "moe_layer_freq": 1,
              "tie_word_embeddings": False}


@dataclasses.dataclass
class MoETextConfig:
    """A DeepSeek-V3-style text model as a caption decoder (this package
    only; the JAX package has no counterpart).

    Defaults are Kimi-VL-A3B-Instruct's language model (its
    ``config.json``, ``text_config``): 27 layers of latent attention (MLA)
    at hidden 2,048, a dense SwiGLU first layer and 26 layers of 64 routed
    experts (top 6, sigmoid router with a selection bias) plus 2 shared
    ones, over 163,840 words.  The image enters as one prefix position, a
    projector (LayerNorm, 4,096 -> 4,096, GELU, -> hidden) of its fc7
    row, followed by ``prompt_ids``; the caption's words come after BOS.
    """

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    cnn_feature_dim: int = CNN_FEATURE_DIM
    projector_dim: int = 4096
    prompt_ids: Sequence[int] = ()
    compute_dtype: str = "bfloat16"
    # the checkpoint's ``config.json`` names its decoder by this field
    decoder: str = "moe_text"

    def __post_init__(self):
        self.prompt_ids = tuple(int(i) for i in self.prompt_ids)
        if not 0 <= self.first_k_dense_replace <= self.num_hidden_layers:
            raise ValueError("first_k_dense_replace must be within the "
                             "layers")
        if not 1 <= self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError("num_experts_per_tok must be in "
                             "1..n_routed_experts")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")

    @classmethod
    def from_dict(cls, values: dict) -> "MoETextConfig":
        """The fields of ``values`` (a published ``text_config`` or a
        checkpoint's ``config.json``); raises where a published setting
        names a variant this decoder does not compute."""
        for key, value in _MOE_FIXED.items():
            if key in values and values[key] != value:
                raise ValueError(f"{key}={values[key]!r} is not supported "
                                 f"(only {value!r})")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in names})

    @property
    def prefix_len(self) -> int:
        """Positions before the caption: the image and the prompt."""
        return 1 + len(self.prompt_ids)

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

"""PyTorch/CUDA port of STCAT-TPU for one NVIDIA H100.

Spatio-temporal video grounding: a clip and a sentence in, a box per frame
and a [start, end) span out. The JAX package ``stcat_tpu`` is the reference
this port is held against; nothing here imports it or JAX.

Layering (bottom-up), mirroring ``stcat_tpu``:
    config      -- dataclass config tree, YAML + CLI overrides
    core        -- batch containers (True = valid masks)
    ops         -- embeddings, boxes, sted decode, on-device preprocess
    kernels     -- hand-written CUDA kernels (csrc/*.cu) + their plain versions
    models      -- ResNet / RoBERTa / cross-modal encoder / decoders / STCATNet
    data        -- host-side tokenizer, transform plan, raw batch assembly
    eval        -- two-stream merge and box interpolation
    serve       -- GroundingPredictor + MicroBatcher
    convert     -- JAX parameter trees -> this package's state_dict

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import os as _os

_os.environ.setdefault("HF_HUB_OFFLINE", "1")
_os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

__version__ = "0.1.0"

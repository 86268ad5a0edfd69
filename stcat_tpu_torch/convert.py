"""JAX parameter trees -> this package's state_dict.

``from_jax_variables(params, constants)`` takes the JAX package's
{"params", "constants"} trees as nested dicts of numpy arrays and returns the
port's ``state_dict`` (reference STCAT names):

  * Dense ``kernel`` [in, out]        -> Linear ``weight`` [out, in]
  * Conv ``kernel`` HWIO              -> Conv2d ``weight`` OIHW
  * LayerNorm / GroupNorm ``scale``   -> ``weight``
  * FrozenBN constants (scale, bias)  -> buffers weight = scale, bias,
    running_mean = 0, running_var = 1 - eps (so weight * rsqrt(var + eps)
    gives back the scale)
  * q/k/v projections of an attention -> packed ``in_proj_weight`` / ``in_proj_bias``
  * flax LSTM cells (MODEL.USE_LSTM)  -> ``torch.nn.LSTM`` weights (``lstm_text``)

It is the inverse of ``stcat_tpu/train/convert_reference.py``'s
``convert_reference_stcat`` on everything that function does not fold.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.resnet import BN_EPS


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class Writer:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value) -> None:
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))

    def dense(self, prefix: str, node: Dict) -> None:
        self.put(prefix + ".weight", _np(node["kernel"]).T)
        self.put(prefix + ".bias", node["bias"])

    def norm(self, prefix: str, node: Dict) -> None:
        self.put(prefix + ".weight", node["scale"])
        self.put(prefix + ".bias", node["bias"])

    def frozen_bn(self, prefix: str, node: Dict) -> None:
        scale = _np(node["scale"])
        self.put(prefix + ".weight", scale)
        self.put(prefix + ".bias", node["bias"])
        self.put(prefix + ".running_mean", np.zeros_like(scale))
        self.put(prefix + ".running_var", np.full_like(scale, 1.0 - BN_EPS))

    def conv(self, prefix: str, node: Dict) -> None:
        self.put(prefix + ".weight", _np(node["kernel"]).transpose(3, 2, 0, 1))

    def mha(self, prefix: str, node: Dict) -> None:
        parts = [node[n] for n in ("q_proj", "k_proj", "v_proj")]
        self.put(prefix + ".in_proj_weight", np.concatenate([_np(p["kernel"]).T for p in parts]))
        self.put(prefix + ".in_proj_bias", np.concatenate([_np(p["bias"]) for p in parts]))
        self.dense(prefix + ".out_proj", node["out_proj"])

    def mlp(self, prefix: str, node: Dict) -> None:
        for j in range(len(node)):
            self.dense(f"{prefix}.layers.{j}", node[f"layer_{j}"])

    def encoder_layer(self, prefix: str, node: Dict) -> None:
        self.mha(prefix + ".self_attn", node["self_attn"])
        for n in ("linear1", "linear2"):
            self.dense(f"{prefix}.{n}", node[n])
        for n in ("norm1", "norm2"):
            self.norm(f"{prefix}.{n}", node[n])


def backbone(w: Writer, params: Dict, consts: Dict, pre: str = "") -> None:
    """ResNet tree (params + FrozenBN constants) -> torchvision names."""

    def norm(dst: str, name: str, pnode: Dict, cnode: Dict) -> None:
        if name in cnode:
            w.frozen_bn(dst, cnode[name])
        else:  # GroupNorm variant: a trainable affine in params
            w.norm(dst, pnode[name])

    w.conv(pre + "conv1", params["stem_conv"])
    norm(pre + "bn1", "stem_bn", params, consts)
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        dst = f"{pre}layer{stage}.{block}."
        pnode, cnode = params[name], consts.get(name, {})
        for i in (1, 2, 3):
            w.conv(dst + f"conv{i}", pnode[f"conv{i}"])
            norm(dst + f"bn{i}", f"bn{i}", pnode, cnode)
        if "ds_conv" in pnode:
            w.conv(dst + "downsample.0", pnode["ds_conv"])
            norm(dst + "downsample.1", "ds_bn", pnode, cnode)


def roberta(w: Writer, node: Dict, pre: str = "") -> None:
    """Roberta tree -> HuggingFace RobertaModel names."""
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        w.put(f"{pre}embeddings.{n}.weight", node[n]["embedding"])
    w.norm(pre + "embeddings.LayerNorm", node["emb_ln"])
    for i in range(sum(k.startswith("layer_") for k in node)):
        src, dst = node[f"layer_{i}"], f"{pre}encoder.layer.{i}."
        attn = src["attention"]
        for ours, theirs in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value")):
            w.dense(f"{dst}attention.self.{theirs}", attn[ours])
        w.dense(dst + "attention.output.dense", attn["out_proj"])
        w.norm(dst + "attention.output.LayerNorm", src["attn_ln"])
        w.dense(dst + "intermediate.dense", src["intermediate"])
        w.dense(dst + "output.dense", src["output"])
        w.norm(dst + "output.LayerNorm", src["out_ln"])
    w.dense(pre + "pooler.dense", node["pooler"])


def lstm_text(w: Writer, node: Dict, pre: str = "") -> None:
    """LSTMTextEncoder tree -> one torch.nn.LSTM per direction and layer.
    flax names the cells OptimizedLSTMCell_<k> in creation order: layer by
    layer, forward then backward (bidirectional when the projection takes
    twice a cell's width). Each cell's per-gate kernels, in flax's order i, f,
    g, o (torch's too), stack into weight_ih_l0 [4h, in] and weight_hh_l0
    [4h, h]; the hidden biases are bias_hh_l0, and bias_ih_l0 is 0 (flax
    keeps one bias per gate)."""
    w.put(pre + "embedding.weight", node["embedding"]["embedding"])
    cells = sorted((k for k in node if k.startswith("OptimizedLSTMCell_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    hidden = _np(node[cells[0]]["hi"]["kernel"]).shape[0]
    bidirectional = _np(node["proj"]["kernel"]).shape[0] == 2 * hidden
    for k, name in enumerate(cells):
        cell = node[name]
        dst = (f"{pre}{('fwd', 'bwd')[k % 2]}_{k // 2}" if bidirectional else f"{pre}fwd_{k}")
        w.put(dst + ".weight_ih_l0", np.concatenate([_np(cell["i" + g]["kernel"]).T
                                                     for g in "ifgo"]))
        w.put(dst + ".weight_hh_l0", np.concatenate([_np(cell["h" + g]["kernel"]).T
                                                     for g in "ifgo"]))
        bias = np.concatenate([_np(cell["h" + g]["bias"]) for g in "ifgo"])
        w.put(dst + ".bias_ih_l0", np.zeros_like(bias))
        w.put(dst + ".bias_hh_l0", bias)
    w.dense(pre + "proj", node["proj"])


def encoder(w: Writer, enc: Dict, pre: str = "") -> None:
    """CrossModalEncoder tree -> reference names."""
    for i in range(sum(k.startswith("spatial_") for k in enc)):
        w.encoder_layer(f"{pre}spatial_layers.{i}", enc[f"spatial_{i}"])
        w.encoder_layer(f"{pre}temporal_layers.{i}", enc[f"temporal_{i}"])
    for tok in ("frame_cls", "video_cls", "local_pos_embed"):
        w.put(f"{pre}{tok}.weight", _np(enc[tok])[None])
    if "time_embed" in enc:
        w.put(pre + "time_embed.embed.weight", enc["time_embed"]["embed"])


def spatial_decoder(w: Writer, dec: Dict, pre: str = "") -> None:
    """SpatialDecoder tree (without the shared bbox_embed) -> reference names."""
    w.mlp(pre + "query_scale", dec["query_scale"])
    w.mlp(pre + "ref_point_head", dec["ref_point_head"])
    w.norm(pre + "norm", dec["norm"])
    for i in range(sum(k.startswith("layer_") for k in dec)):
        src, dst = dec[f"layer_{i}"], f"{pre}layers.{i}."
        w.mha(dst + "self_attn", src["self_attn"])
        if "q_proj" in src["cross_attn"]:
            w.mha(dst + "cross_attn_image", src["cross_attn"])
        else:
            w.dense(dst + "cross_attn.out_proj", src["cross_attn"]["out_proj"])
        for n, node in src.items():
            if n.startswith(("sa_", "ca_", "linear")):
                w.dense(dst + n, node)
            elif n.startswith("norm"):
                w.norm(dst + n, node)


def time_decoder(w: Writer, tdec: Dict, pre: str = "") -> None:
    """TimeDecoder tree -> reference names."""
    w.norm(pre + "norm", tdec["norm"])
    for i in range(sum(k.startswith("layer_") for k in tdec)):
        src, dst = tdec[f"layer_{i}"], f"{pre}layers.{i}."
        w.mha(dst + "self_attn", src["self_attn"])
        w.mha(dst + "cross_attn_image", src["cross_attn"])
        for n in ("linear1", "linear2"):
            w.dense(dst + n, src[n])
        for n in ("norm1", "norm3", "norm4"):
            w.norm(dst + n, src[n])


def from_jax_variables(params: Dict, constants: Dict) -> Dict[str, torch.Tensor]:
    """JAX {"params", "constants"} trees (nested dicts of arrays) -> state_dict."""
    w = Writer()
    backbone(w, params["vis_encoder"], constants.get("vis_encoder", {}), "vis_encoder.0.body.")
    if "pos_encoding" in params:
        learned = params["pos_encoding"]["learned"]
        w.put("vis_encoder.1.row_embed.weight", learned["row_embed"])
        w.put("vis_encoder.1.col_embed.weight", learned["col_embed"])
    kernel = _np(params["input_proj"]["kernel"])  # [2048, d]
    w.put("input_proj.weight", kernel.T[:, :, None, None])
    w.put("input_proj.bias", params["input_proj"]["bias"])

    text = params["text_encoder"]
    if "roberta" in text:
        roberta(w, text["roberta"], "text_encoder.body.")
        w.dense("text_encoder.resizer.fc", text["resizer"]["fc"])
        w.norm("text_encoder.resizer.layer_norm", text["resizer"]["ln"])
    else:  # MODEL.USE_LSTM
        lstm_text(w, text, "text_encoder.")

    encoder(w, params["ground_encoder"], "ground_encoder.encoder.")

    for n, node in params["template_generator"].items():
        w.dense(f"ground_decoder.template_generator.{n}", node)
    spatial_decoder(w, params["decoder"], "ground_decoder.decoder.")
    time_decoder(w, params["temp_decoder"], "ground_decoder.temp_decoder.")
    if "dec_time_embed" in params:
        w.put("ground_decoder.time_embed.embed.weight", params["dec_time_embed"]["embed"])

    for head in ("bbox_embed", "temp_embed", "action_embed"):
        if head in params:
            w.mlp(head, params[head])
    return w.sd

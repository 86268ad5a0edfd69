"""Reference STCAT and MDETR torch checkpoints into the port's model.

The port's parameter names are the reference STCAT state_dict's, so a
reference ``.pth`` loads with ``load_state_dict``; what is left is a strict
report of missing and unused keys, the MDETR key remap, and the partial
load of an MDETR checkpoint. That load goes by the sections of the JAX
package's ``convert_reference_stcat``: a section (the backbone, the text
encoder, the spatial encoder, ...) loads only when each of its required
parts is complete in the checkpoint, and keeps its fresh weights otherwise.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import torch
from torch import nn

# keys of a reference checkpoint that the port has no counterpart for: BN
# step counters, the fixed sine time tables (recomputed) and the reference's
# unused ground_encoder.fusion module
_IGNORED = re.compile(r"(num_batches_tracked$|\.time_embed\.te$|^ground_encoder\.fusion\."
                      r"|^ground_encoder\.encoder\.time_embed\.)")


def remap_mdetr(mdetr_sd: Dict) -> Dict:
    """MDETR checkpoint names -> reference STCAT names (backbone ->
    vis_encoder, transformer.text_encoder / resizer -> text_encoder,
    transformer.encoder layers -> the spatial encoder layers,
    transformer.decoder -> ground_decoder; input_proj and bbox_embed as
    they are). Other keys are dropped."""
    out = {}
    for k, v in mdetr_sd.items():
        if k.startswith("backbone."):
            out[k.replace("backbone.", "vis_encoder.", 1)] = v
        elif k.startswith("transformer.text_encoder."):
            out[k.replace("transformer.text_encoder.", "text_encoder.body.", 1)] = v
        elif k.startswith("transformer.resizer."):
            out[k.replace("transformer.resizer.", "text_encoder.resizer.", 1)] = v
        elif k.startswith("transformer.encoder.layers."):
            out[k.replace("transformer.encoder.layers.",
                          "ground_encoder.encoder.spatial_layers.", 1)] = v
        elif k.startswith("transformer.decoder."):
            out[k.replace("transformer.", "ground_decoder.", 1)] = v
        elif k.startswith(("input_proj.", "bbox_embed.")):
            out[k] = v
    return out


_LAYER = re.compile(r"^(ground_encoder\.encoder\.(spatial|temporal)_layers\.\d+\.)")
_SECTIONS = ("vis_encoder.0.body.", "input_proj.", "text_encoder.",
             "ground_decoder.template_generator.", "ground_decoder.decoder.",
             "ground_decoder.temp_decoder.", "bbox_embed.")


def _unit(key: str) -> Tuple[str, str, bool]:
    """(section, unit, required) of a model key: a section loads only if its
    required units are complete; its optional units load where complete."""
    m = _LAYER.match(key)
    if m:
        return "encoder", m.group(1), m.group(2) == "spatial"
    if key.startswith("ground_encoder.encoder."):
        return "encoder", key, False   # cls tokens, local position table, time table
    if key.startswith("vis_encoder.1."):
        return "pos", "vis_encoder.1.", False
    if key.startswith("ground_decoder.time_embed."):
        return "ground_decoder.temp_decoder.", "ground_decoder.time_embed.", False
    if key.startswith(("temp_embed.", "action_embed.")):
        return "bbox_embed.", key.split(".")[0], False
    for section in _SECTIONS:
        if key.startswith(section):
            return section, section, True
    raise KeyError(f"no section for model key {key}")


def partial_keys(model_keys: List[str], sd: Dict) -> List[str]:
    """The model keys a partial checkpoint ``sd`` initialises."""
    units: Dict[Tuple[str, str, bool], List[str]] = {}
    for k in model_keys:
        units.setdefault(_unit(k), []).append(k)
    complete = {u: all(k in sd for k in ks) for u, ks in units.items()}
    broken = {u[0] for u, ok in complete.items() if u[2] and not ok}
    return [k for u, ks in units.items() if complete[u] and u[0] not in broken for k in ks]


def load_reference_state_dict(model: nn.Module, sd: Dict, strict: bool = True,
                              logger=None) -> List[str]:
    """Reference-named weights into ``model`` in place; returns the loaded
    keys. strict: every model key must be in ``sd`` (KeyError otherwise);
    otherwise (a partial checkpoint) the complete sections load. Keys of
    ``sd`` that nothing took are reported, the known ones aside."""
    own = model.state_dict()
    keys = list(own) if strict else partial_keys(list(own), sd)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{len(missing)} model keys missing from the checkpoint: {missing[:5]}")
    unused = sorted(k for k in sd if k not in own and not _IGNORED.search(k))
    if unused and logger is not None:
        logger.warning(f"{len(unused)} checkpoint keys unused: {unused[:5]} ...")
    with torch.no_grad():
        for k in keys:
            src = torch.as_tensor(sd[k])
            if tuple(src.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: checkpoint shape {tuple(src.shape)} != model "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(src)
    return keys


def load_pretrained_weight(cfg, state, logger) -> None:
    """Training's MODEL.WEIGHT, a torch file: an MDETR checkpoint (keys under
    ``transformer.``) initialises the sections it covers, a reference STCAT
    checkpoint every weight; the EMA then starts as a copy of the weights."""
    from .checkpoint import load_torch_file

    path = cfg.MODEL.WEIGHT
    if not path.endswith((".pth", ".pt", ".bin")):
        logger.info(f"MODEL.WEIGHT {path} is not a torch checkpoint; skipping "
                    "(checkpoint directories are restored by the resume path)")
        return
    if not os.path.exists(path):
        logger.warning(f"MODEL.WEIGHT {path} not found; training from scratch")
        return
    sd = load_torch_file(path)
    if any(k.startswith("transformer.") for k in sd):
        logger.info("detected an MDETR-style checkpoint; partial init")
        loaded = load_reference_state_dict(state.model, remap_mdetr(sd), strict=False,
                                           logger=logger)
    else:
        loaded = load_reference_state_dict(state.model, sd, logger=logger)
    logger.info(f"initialised {len(loaded)} weights from {path}")
    if state.ema is not None:
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                state.ema[name].copy_(p)

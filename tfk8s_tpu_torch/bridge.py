"""The one place that knows how the JAX package's flax parameter tree maps
onto the port's ``state_dict``, both ways.

The flax side is the nested dict of numpy arrays that the reference's
``unbox(task.init(key))`` gives for the shared transformer stack
(``BertWithHead``, and so ``GPTLM``):

- ``embed/tok/embedding`` [V, E] and ``embed/pos`` [max_len, E];
- ``layer{i}/attn/{q,k,v}/kernel`` [E, H, D] with ``bias`` [H, D];
- ``layer{i}/attn/out/kernel`` [H, D, E] with ``bias`` [E];
- ``layer{i}/mlp/{wi,wo}/{kernel,bias}`` ([in, out] kernels);
- ``layer{i}/{ln_attn,ln_mlp}`` and ``ln_final`` ``{scale, bias}``.

The port stores ``nn.Linear`` weights as ``[out, in]``, so every kernel
is flattened to 2-D and transposed (the same relabel/reshape the
reference's ``load_hf_gpt2``/``save_hf_gpt2`` do for Hugging Face's
GPT-2). Values are float32 either way.

The ResNet tree (``models/resnet.py``) maps leaf by leaf under the same
module names (``stem``, ``stem_norm``, ``stage{s}_block{i}/{conv1,norm1,
...,proj,proj_norm}``, ``classifier``): a conv ``kernel`` [kh, kw, in,
out] (HWIO) becomes ``weight`` [out, in, kh, kw] (OIHW), a GroupNorm
``scale``/``bias`` becomes ``weight``/``bias``, and the classifier's dense
``kernel`` [in, out] becomes ``weight`` [out, in].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tfk8s_tpu_torch.models.transformer import TransformerConfig

_PROJ = ("q", "k", "v")


def params_to_state_dict(params: Mapping[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's ``state_dict``."""
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd = {
        "embed.tok.weight": t(params["embed"]["tok"]["embedding"]),
        "embed.pos": t(params["embed"]["pos"]),
        "ln_final.weight": t(params["ln_final"]["scale"]),
        "ln_final.bias": t(params["ln_final"]["bias"]),
    }
    for i in range(cfg.num_layers):
        lp, p = params[f"layer{i}"], f"layers.{i}"
        for name in _PROJ:
            kern = np.asarray(lp["attn"][name]["kernel"]).reshape(e, h * d)
            sd[f"{p}.attn.{name}.weight"] = t(kern.T)
            sd[f"{p}.attn.{name}.bias"] = t(np.asarray(lp["attn"][name]["bias"]).reshape(h * d))
        out = np.asarray(lp["attn"]["out"]["kernel"]).reshape(h * d, e)
        sd[f"{p}.attn.out.weight"] = t(out.T)
        sd[f"{p}.attn.out.bias"] = t(lp["attn"]["out"]["bias"])
        for name in ("wi", "wo"):
            sd[f"{p}.mlp.{name}.weight"] = t(np.asarray(lp["mlp"][name]["kernel"]).T)
            sd[f"{p}.mlp.{name}.bias"] = t(lp["mlp"][name]["bias"])
        for name in ("ln_attn", "ln_mlp"):
            sd[f"{p}.{name}.weight"] = t(lp[name]["scale"])
            sd[f"{p}.{name}.bias"] = t(lp[name]["bias"])
    return sd


def state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    """The port's ``state_dict`` -> flax param tree (numpy leaves)."""
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim

    def a(name: str) -> np.ndarray:
        return sd[name].detach().to("cpu", torch.float32).numpy().copy()

    params: Dict[str, Any] = {
        "embed": {"tok": {"embedding": a("embed.tok.weight")}, "pos": a("embed.pos")},
        "ln_final": {"scale": a("ln_final.weight"), "bias": a("ln_final.bias")},
    }
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        attn = {
            name: {
                "kernel": a(f"{p}.attn.{name}.weight").T.reshape(e, h, d),
                "bias": a(f"{p}.attn.{name}.bias").reshape(h, d),
            }
            for name in _PROJ
        }
        attn["out"] = {
            "kernel": a(f"{p}.attn.out.weight").T.reshape(h, d, e),
            "bias": a(f"{p}.attn.out.bias"),
        }
        params[f"layer{i}"] = {
            "attn": attn,
            "mlp": {
                name: {"kernel": a(f"{p}.mlp.{name}.weight").T.copy(),
                       "bias": a(f"{p}.mlp.{name}.bias")}
                for name in ("wi", "wo")
            },
            "ln_attn": {"scale": a(f"{p}.ln_attn.weight"), "bias": a(f"{p}.ln_attn.bias")},
            "ln_mlp": {"scale": a(f"{p}.ln_mlp.weight"), "bias": a(f"{p}.ln_mlp.bias")},
        }
    return params


def resnet_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ResNet flax param tree (numpy leaves) -> the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            a = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = "weight" if key in ("kernel", "scale") else key
            sd[prefix + name] = torch.from_numpy(np.ascontiguousarray(a).copy())

    walk(params, "")
    return sd


def resnet_state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ResNet ``state_dict`` -> flax param tree (numpy leaves).
    A 4-D ``weight`` is a conv kernel, a 2-D one the classifier's, a 1-D
    one a GroupNorm scale."""
    params: Dict[str, Any] = {}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            else:
                leaf = "scale"
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(a).copy()
    return params

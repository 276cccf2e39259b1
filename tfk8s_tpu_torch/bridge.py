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

The paged KV cache maps too (``pages_to_torch``/``pages_from_torch``): the
reference's ``pages`` tree holds ``layer{i}/attn/{k_pages,v_pages}``, flat
``[n_pages*page_size, heads, head_dim]`` leaves, and the port keeps the
same buffers as one ``(k, v)`` pair per layer.

So does the slot-per-batch decode cache (``cache_to_torch``/
``cache_from_torch``): the reference's ``cache`` tree holds
``layer{i}/attn/{cached_key,cached_value}`` ``[b, cache_len, heads,
head_dim]`` and a per-layer ``cache_index``; the port's
``transformer.DecodeCache`` holds the same buffers and one shared index.

The MLP classifier (``models/mlp.py``) maps ``fc1``/``fc2`` ``{kernel
[in, out], bias}`` to ``nn.Linear`` ``weight [out, in]`` and ``bias``
(``mlp_params_to_state_dict``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from tfk8s_tpu_torch.models.transformer import DecodeCache, TransformerConfig

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


def pages_to_torch(pages: Mapping[str, Any], cfg: TransformerConfig,
                   device: Any = None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The reference's paged KV tree (``{"layer{i}": {"attn": {"k_pages",
    "v_pages"}}}``, numpy leaves ``[n_pages*ps, heads, head_dim]``) -> the
    port's per-layer ``(k, v)`` pools (``models/gpt.clean_pages``), in
    ``cfg.dtype``. A bfloat16 leaf converts through its raw 2-byte words."""

    def t(a) -> torch.Tensor:
        arr = np.ascontiguousarray(a)
        if arr.dtype.name == "bfloat16":
            out = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out = torch.from_numpy(arr.copy())
        return out.to(device=device, dtype=cfg.dtype)

    return [
        (t(pages[f"layer{i}"]["attn"]["k_pages"]), t(pages[f"layer{i}"]["attn"]["v_pages"]))
        for i in range(cfg.num_layers)
    ]


def pages_from_torch(pages: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, Any]:
    """The port's pools -> the reference's paged KV tree with float32 numpy
    leaves (numpy has no bfloat16; the caller casts to its pool dtype)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy().copy()

    return {
        f"layer{i}": {"attn": {"k_pages": a(k), "v_pages": a(v)}}
        for i, (k, v) in enumerate(pages)
    }


def cache_to_torch(cache: Mapping[str, Any], cfg: TransformerConfig,
                   device: Any = None) -> DecodeCache:
    """The reference's decode-cache tree (numpy leaves) -> a port
    :class:`DecodeCache` in ``cfg.dtype``. Every layer's ``cache_index``
    must agree: the port keeps one."""
    layers = [cache[f"layer{i}"]["attn"] for i in range(cfg.num_layers)]
    indices = {int(np.asarray(a["cache_index"])) for a in layers}
    if len(indices) != 1:
        raise ValueError(f"layers disagree on the cache index: {sorted(indices)}")

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=cfg.dtype)

    return DecodeCache([t(a["cached_key"]) for a in layers],
                       [t(a["cached_value"]) for a in layers],
                       torch.tensor(indices.pop(), dtype=torch.int32, device=device))


def cache_from_torch(cache: DecodeCache) -> Dict[str, Any]:
    """A port :class:`DecodeCache` -> the reference's decode-cache tree
    (float32 numpy buffers, an int32 index per layer)."""

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy().copy()

    index = np.asarray(int(cache.index), np.int32)
    return {
        f"layer{i}": {"attn": {"cached_key": a(k), "cached_value": a(v),
                               "cache_index": index.copy()}}
        for i, (k, v) in enumerate(zip(cache.keys, cache.values))
    }


def mlp_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The MLP classifier's flax tree (numpy leaves) -> the port's
    ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("fc1", "fc2"):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params[name]["kernel"], np.float32).T).copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.array(params[name]["bias"], np.float32, copy=True))
    return sd

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

The other families reuse those per-layer maps: ViT (``vit_params_to_state_dict``)
adds ``patch_embed`` and ``head`` (2-D dense kernels), a float32 ``pos``
[patches, E] and ``layer{i}``/``ln_final`` as above; T5
(``t5_params_to_state_dict``) has ``embed``, encoder layers ``enc{i}``,
decoder layers ``dec{i}`` with ``self_attn``, ``cross_attn`` and the
norms ``ln_self``, ``ln_cross``, ``ln_mlp``, and ``enc_ln``/``dec_ln``,
under the same names on the port's side. The T5 decoder's cache tree
(``dec{i}/self_attn/...``) goes through the cache pair with
``scope=("dec", "self_attn")``.

An MoE layer (``cfg.layer_uses_moe``) holds ``moe/{router [E_model,
experts], wi [experts, E_model, mlp], wo [experts, mlp, E_model]}`` in
place of ``mlp``, the same layouts on both sides (``layers.{i}.moe.*``);
given ``experts=(lo, hi)``, the maps into the port take that slice of
``wi``/``wo``, an expert rank's share.

The MLP classifier (``models/mlp.py``) maps ``fc1``/``fc2`` ``{kernel
[in, out], bias}`` to ``nn.Linear`` ``weight [out, in]`` and ``bias``
(``mlp_params_to_state_dict``); DLRM (``models/dlrm.py``) its tables
``table{t}/embedding`` and the dense layers of ``bottom``/``top`` the same
way (``dlrm_params_to_state_dict``).

The pipelined BERT (``models/pipelined.py``) holds ``embed`` and
``ln_final`` as above and ``stages/layer{j}``, each leaf stacked ``[S,
...]`` over the stages; stage s's ``layer{j}`` is the port's global layer
``layers.{s * L / S + j}`` (``pipelined_params_to_state_dict``, with
``stage=`` one rank's share).

Every map is of whole parameters. A tensor-split model takes its rank's
blocks of a bridged state dict (``parallel/tensor_parallel.shard_state_dict``)
and gives whole ones back through a checkpoint's gather
(``parallel/data_parallel.state_dicts``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tfk8s_tpu_torch.models.transformer import DecodeCache, TransformerConfig

_PROJ = ("q", "k", "v")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _a(sd: Mapping[str, torch.Tensor], name: str) -> np.ndarray:
    return sd[name].detach().to("cpu", torch.float32).numpy().copy()


def _attn_to_sd(tree: Mapping[str, Any], prefix: str, cfg: TransformerConfig,
                sd: Dict[str, torch.Tensor]) -> None:
    """One ``MultiHeadAttention``'s flax subtree -> ``sd[prefix + ...]``."""
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    for name in _PROJ:
        kern = np.asarray(tree[name]["kernel"]).reshape(e, h * d)
        sd[f"{prefix}.{name}.weight"] = _t(kern.T)
        sd[f"{prefix}.{name}.bias"] = _t(np.asarray(tree[name]["bias"]).reshape(h * d))
    out = np.asarray(tree["out"]["kernel"]).reshape(h * d, e)
    sd[f"{prefix}.out.weight"] = _t(out.T)
    sd[f"{prefix}.out.bias"] = _t(tree["out"]["bias"])


def _attn_from_sd(sd: Mapping[str, torch.Tensor], prefix: str,
                  cfg: TransformerConfig) -> Dict[str, Any]:
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    attn = {
        name: {
            "kernel": _a(sd, f"{prefix}.{name}.weight").T.reshape(e, h, d),
            "bias": _a(sd, f"{prefix}.{name}.bias").reshape(h, d),
        }
        for name in _PROJ
    }
    attn["out"] = {
        "kernel": _a(sd, f"{prefix}.out.weight").T.reshape(h, d, e),
        "bias": _a(sd, f"{prefix}.out.bias"),
    }
    return attn


def _dense_to_sd(tree: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    """A 2-D dense ``{kernel [in, out], bias}`` -> ``nn.Linear``."""
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _dense_from_sd(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    return {"kernel": _a(sd, f"{prefix}.weight").T.copy(), "bias": _a(sd, f"{prefix}.bias")}


def _ln_to_sd(tree: Mapping[str, Any], prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _ln_from_sd(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    return {"scale": _a(sd, f"{prefix}.weight"), "bias": _a(sd, f"{prefix}.bias")}


# a layer's attention blocks and norms by kind, under the same names on both sides
_LAYER_PARTS = {
    "encoder": (("attn",), ("ln_attn", "ln_mlp")),
    "decoder": (("self_attn", "cross_attn"), ("ln_self", "ln_cross", "ln_mlp")),
}


def _layer_to_sd(tree: Mapping[str, Any], prefix: str, cfg: TransformerConfig,
                 sd: Dict[str, torch.Tensor], kind: str = "encoder",
                 experts: Optional[Tuple[int, int]] = None) -> None:
    attns, norms = _LAYER_PARTS[kind]
    for name in attns:
        _attn_to_sd(tree[name], f"{prefix}.{name}", cfg, sd)
    if "moe" in tree:
        lo, hi = experts or (0, cfg.num_experts)
        sd[f"{prefix}.moe.router"] = _t(tree["moe"]["router"])
        for name in ("wi", "wo"):
            sd[f"{prefix}.moe.{name}"] = _t(np.asarray(tree["moe"][name])[lo:hi])
    else:
        for name in ("wi", "wo"):
            _dense_to_sd(tree["mlp"][name], f"{prefix}.mlp.{name}", sd)
    for name in norms:
        _ln_to_sd(tree[name], f"{prefix}.{name}", sd)


def _layer_from_sd(sd: Mapping[str, torch.Tensor], prefix: str, cfg: TransformerConfig,
                   kind: str = "encoder") -> Dict[str, Any]:
    attns, norms = _LAYER_PARTS[kind]
    out: Dict[str, Any] = {name: _attn_from_sd(sd, f"{prefix}.{name}", cfg) for name in attns}
    if f"{prefix}.moe.router" in sd:
        out["moe"] = {name: _a(sd, f"{prefix}.moe.{name}") for name in ("router", "wi", "wo")}
    else:
        out["mlp"] = {name: _dense_from_sd(sd, f"{prefix}.mlp.{name}") for name in ("wi", "wo")}
    out.update((name, _ln_from_sd(sd, f"{prefix}.{name}")) for name in norms)
    return out


def _embed_to_sd(tree: Mapping[str, Any], sd: Dict[str, torch.Tensor]) -> None:
    sd["embed.tok.weight"] = _t(tree["tok"]["embedding"])
    sd["embed.pos"] = _t(tree["pos"])


def _embed_from_sd(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    return {"tok": {"embedding": _a(sd, "embed.tok.weight")}, "pos": _a(sd, "embed.pos")}


def params_to_state_dict(params: Mapping[str, Any], cfg: TransformerConfig,
                         experts: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's ``state_dict``, for the
    shared stack (``BertWithHead``: BERT and GPT; and ``Encoder``);
    ``experts``: the expert rows an expert rank holds."""
    sd: Dict[str, torch.Tensor] = {}
    _embed_to_sd(params["embed"], sd)
    _ln_to_sd(params["ln_final"], "ln_final", sd)
    for i in range(cfg.num_layers):
        _layer_to_sd(params[f"layer{i}"], f"layers.{i}", cfg, sd, experts=experts)
    return sd


def state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: TransformerConfig) -> Dict[str, Any]:
    """The port's ``state_dict`` -> flax param tree (numpy leaves)."""
    params: Dict[str, Any] = {"embed": _embed_from_sd(sd), "ln_final": _ln_from_sd(sd, "ln_final")}
    for i in range(cfg.num_layers):
        params[f"layer{i}"] = _layer_from_sd(sd, f"layers.{i}", cfg)
    return params


def pipelined_params_to_state_dict(params: Mapping[str, Any], cfg: TransformerConfig,
                                   num_stages: int, stage: Optional[int] = None
                                   ) -> Dict[str, torch.Tensor]:
    """The reference's pipelined BERT tree (``embed``, ``stages/layer{j}``
    with ``[S, ...]`` leaves, ``ln_final``) -> the port's ``state_dict``
    (``models/pipelined.PipelinedBert``): every layer under its global
    index, or only stage ``stage``'s (with the embedding and final norm,
    which every stage holds)."""
    per = cfg.num_layers // num_stages
    sd: Dict[str, torch.Tensor] = {}
    _embed_to_sd(params["embed"], sd)
    _ln_to_sd(params["ln_final"], "ln_final", sd)
    for s in range(num_stages) if stage is None else (stage,):
        for j in range(per):
            tree = _index_tree(params["stages"][f"layer{j}"], s)
            _layer_to_sd(tree, f"layers.{s * per + j}", cfg, sd)
    return sd


def pipelined_state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: TransformerConfig,
                                   num_stages: int) -> Dict[str, Any]:
    """The port's whole pipelined ``state_dict`` -> the reference's tree,
    each stage's ``layer{j}`` stacked ``[S, ...]``."""
    per = cfg.num_layers // num_stages
    layers = [_layer_from_sd(sd, f"layers.{i}", cfg) for i in range(cfg.num_layers)]
    stages = {f"layer{j}": _stack_trees([layers[s * per + j] for s in range(num_stages)])
              for j in range(per)}
    return {"embed": _embed_from_sd(sd), "stages": stages, "ln_final": _ln_from_sd(sd, "ln_final")}


def _index_tree(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _stack_trees(trees: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    return {k: _stack_trees([t[k] for t in trees]) if isinstance(v, Mapping)
            else np.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def vit_params_to_state_dict(params: Mapping[str, Any], cfg: TransformerConfig,
                             experts: Optional[Tuple[int, int]] = None
                             ) -> Dict[str, torch.Tensor]:
    """ViT flax tree (``patch_embed``, ``pos``, ``layer{i}``, ``ln_final``,
    ``head``) -> the port's ``state_dict`` (``models/vit.ViT``)."""
    sd: Dict[str, torch.Tensor] = {"pos": _t(params["pos"])}
    _dense_to_sd(params["patch_embed"], "patch_embed", sd)
    _dense_to_sd(params["head"], "head", sd)
    _ln_to_sd(params["ln_final"], "ln_final", sd)
    for i in range(cfg.num_layers):
        _layer_to_sd(params[f"layer{i}"], f"layers.{i}", cfg, sd, experts=experts)
    return sd


def vit_state_dict_to_params(sd: Mapping[str, torch.Tensor],
                             cfg: TransformerConfig) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "pos": _a(sd, "pos"), "patch_embed": _dense_from_sd(sd, "patch_embed"),
        "head": _dense_from_sd(sd, "head"), "ln_final": _ln_from_sd(sd, "ln_final"),
    }
    for i in range(cfg.num_layers):
        params[f"layer{i}"] = _layer_from_sd(sd, f"layers.{i}", cfg)
    return params


def t5_params_to_state_dict(params: Mapping[str, Any], cfg: TransformerConfig,
                            experts: Optional[Tuple[int, int]] = None
                            ) -> Dict[str, torch.Tensor]:
    """T5 flax tree (``embed``, ``enc{i}``, ``dec{i}`` with ``self_attn``,
    ``cross_attn`` and three norms, ``enc_ln``, ``dec_ln``) -> the port's
    ``state_dict`` (``models/t5.T5``, the same names)."""
    sd: Dict[str, torch.Tensor] = {}
    _embed_to_sd(params["embed"], sd)
    for name in ("enc_ln", "dec_ln"):
        _ln_to_sd(params[name], name, sd)
    for i in range(cfg.num_layers):
        _layer_to_sd(params[f"enc{i}"], f"enc{i}", cfg, sd, experts=experts)
        _layer_to_sd(params[f"dec{i}"], f"dec{i}", cfg, sd, kind="decoder")
    return sd


def t5_state_dict_to_params(sd: Mapping[str, torch.Tensor],
                            cfg: TransformerConfig) -> Dict[str, Any]:
    params: Dict[str, Any] = {"embed": _embed_from_sd(sd)}
    for name in ("enc_ln", "dec_ln"):
        params[name] = _ln_from_sd(sd, name)
    for i in range(cfg.num_layers):
        params[f"enc{i}"] = _layer_from_sd(sd, f"enc{i}", cfg)
        params[f"dec{i}"] = _layer_from_sd(sd, f"dec{i}", cfg, kind="decoder")
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
                   device: Any = None, scope: Tuple[str, str] = ("layer", "attn")) -> DecodeCache:
    """The reference's decode-cache tree (numpy leaves) -> a port
    :class:`DecodeCache` in ``cfg.dtype``. Every layer's ``cache_index``
    must agree: the port keeps one. ``scope`` names a layer's subtree:
    ``("layer", "attn")`` for the GPT stack, ``("dec", "self_attn")`` for
    the T5 decoder."""
    layer, attn = scope
    layers = [cache[f"{layer}{i}"][attn] for i in range(cfg.num_layers)]
    indices = {int(np.asarray(a["cache_index"])) for a in layers}
    if len(indices) != 1:
        raise ValueError(f"layers disagree on the cache index: {sorted(indices)}")

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=cfg.dtype)

    return DecodeCache([t(a["cached_key"]) for a in layers],
                       [t(a["cached_value"]) for a in layers],
                       torch.tensor(indices.pop(), dtype=torch.int32, device=device))


def cache_from_torch(cache: DecodeCache,
                     scope: Tuple[str, str] = ("layer", "attn")) -> Dict[str, Any]:
    """A port :class:`DecodeCache` -> the reference's decode-cache tree
    (float32 numpy buffers, an int32 index per layer), under ``scope`` as
    for :func:`cache_to_torch`."""
    layer, attn = scope

    def a(x: torch.Tensor) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy().copy()

    index = np.asarray(int(cache.index), np.int32)
    return {
        f"{layer}{i}": {attn: {"cached_key": a(k), "cached_value": a(v),
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


def dlrm_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """DLRM's flax tree (numpy leaves: ``table{t}/embedding`` [V_t, E],
    ``bottom|top/fc{i}/{kernel [in, out], bias}``) -> the port's
    ``state_dict`` (``table{t}.weight``, ``bottom|top.fc{i}.weight [out,
    in]`` and ``bias``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in params.items():
        if name.startswith("table"):
            sd[f"{name}.weight"] = _t(tree["embedding"])
        else:
            for layer, dense in tree.items():
                _dense_to_sd(dense, f"{name}.{layer}", sd)
    return sd


def dlrm_state_dict_to_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's DLRM ``state_dict`` (whole, not a tensor rank's blocks)
    -> the reference's flax tree."""
    out: Dict[str, Any] = {}
    for key in sd:
        name, rest = key.split(".", 1)
        if name.startswith("table"):
            out[name] = {"embedding": _a(sd, key)}
        elif rest.endswith(".weight"):
            layer = rest[:-len(".weight")]
            out.setdefault(name, {})[layer] = _dense_from_sd(sd, f"{name}.{layer}")
    return out

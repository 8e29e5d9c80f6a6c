"""Checkpoint IO: train-state `save`/`restore` with `torch.save`, and the
reading of the reference's torch state dicts.

Train state: the parameters, the optimizer state and the step count, for
the launcher's `--resume`. The JAX package writes Orbax roots instead;
those are a JAX artefact and are not read here.

Reference checkpoints: `load_torch_state_dict` reads a `.bin`/`.pth`
pickle (memory-mapped, weights only) or a `.safetensors` file (its own
reader: the header, then `torch.frombuffer` over a memory map, so no
package is needed), keeping every tensor in its file dtype. `shard_files`
lists a directory's weight shards as the JAX loader does.

`KeyMap` holds one model's key mapping as a table of `Rule`s read both
ways: `to_port` renames a reference state dict to the port module's own
parameter names (torch layout, so linears and convs need no transposes),
`to_ref` writes port tensors back under the reference's keys. A reference
key that no rule takes and no ignore entry names raises. `load_module`
copies mapped tensors into a module strictly (every parameter set, no
tensor left over, shapes equal), casting each on the module's device.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import mmap
import os
import re
import struct
import time
import zipfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch


def save(path: str, state: Dict[str, Any]) -> int:
    """Write `state` ({"params": module or its state dict, "opt_state":
    {...}, "step": int}) to `path` atomically (a temporary file, then a
    rename). Returns the file's size in bytes."""
    params = state["params"]
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    blob = {"params": sd, "opt_state": state["opt_state"],
            "step": int(state["step"])}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        return {k: _copy_into(dst[k], src[k]) for k in dst}
    if isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint: {len(src)} entries where the state has {len(dst)}")
        return [_copy_into(d, s) for d, s in zip(dst, src)]
    return src


@torch.no_grad()
def restore(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """Load a `save`d state into `like` (same module and optimizer layout)
    in place, on `like`'s devices; returns `like`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    like["params"].load_state_dict(blob["params"])
    like["opt_state"] = _copy_into(like["opt_state"], blob["opt_state"])
    like["step"] = int(blob["step"])
    return like


# ------------------------------------------------------ reference checkpoints

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file as CPU tensors over a private memory map: an
    8-byte little-endian header length, the JSON header, then the data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        # copy-on-write, so the tensors are writable; nothing is copied unless written
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {key} has dtype {info['dtype']}, which is not read")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = [int(d) for d in info["shape"]]
        count = 1
        for d in shape:
            count *= d
        if end - start != count * dtype.itemsize or base + end > len(mm):
            raise ValueError(f"{path}: {key} spans bytes {start}..{end}, not {count} x {dtype}")
        t = (torch.frombuffer(mm, dtype=dtype, count=count, offset=base + start) if count
             else torch.empty(0, dtype=dtype))
        out[key] = t.reshape(shape)
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint file as {key: CPU tensor} in its file dtypes.
    Pickles are read with `weights_only=True`, memory-mapped when they are
    in torch's zip format; a dict nested under `state_dict` or `model` is
    unwrapped. A missing file raises `FileNotFoundError`."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path))
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    bad = [k for k, v in sd.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise ValueError(f"{path}: entries that are not tensors: {bad[:5]}")
    return dict(sd)


def shard_files(path: str) -> List[str]:
    """The weight shards of an HF or diffusers directory, as the JAX loader
    takes them: every `*.safetensors`, else every `pytorch_model*.bin`, else
    every `diffusion_pytorch_model*.bin`, sorted."""
    files = sorted(
        glob.glob(os.path.join(path, "*.safetensors"))
        or glob.glob(os.path.join(path, "pytorch_model*.bin"))
        or glob.glob(os.path.join(path, "diffusion_pytorch_model*.bin"))
    )
    if not files:
        raise FileNotFoundError(f"no weight shards under {path}")
    return files


def load_sharded(path: str) -> Dict[str, torch.Tensor]:
    """Every shard of a directory in one dict (a later shard's key wins, as
    in the JAX loader)."""
    sd: Dict[str, torch.Tensor] = {}
    for f in shard_files(path):
        sd.update(load_torch_state_dict(f))
    return sd


# ------------------------------------------------------------- key mapping

Transform = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Rule:
    """`ref` is a reference key and `port` a port parameter name, each a
    template whose `{name}` fields stand for integers. A tuple of port names
    takes the reference tensor split evenly along its first axis (and joins
    them back). `fwd` maps a reference tensor to the port layout and `bwd`
    back; both default to the identity."""

    ref: str
    port: Union[str, Tuple[str, ...]]
    fwd: Optional[Transform] = None
    bwd: Optional[Transform] = None

    @property
    def ports(self) -> Tuple[str, ...]:
        return self.port if isinstance(self.port, tuple) else (self.port,)


def _pattern(template: str) -> "re.Pattern":
    body = re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>\\d+)", re.escape(template))
    return re.compile(body)


def _prefix(template: str) -> str:
    return template.split("{", 1)[0]


class KeyMap:
    """One model's mapping between reference keys and port parameter names.

    `ignore` lists (regex, reason) for reference keys the port does not
    read, such as buffers it recomputes; `aliases` lists (regex, template)
    for keys that name the same tensor as another key (shared modules): an
    alias is read only when the key it names is absent."""

    def __init__(self, rules: Iterable[Rule], ignore: Sequence[Tuple[str, str]] = (),
                 aliases: Sequence[Tuple[str, str]] = ()):
        self.rules = list(rules)
        self.ignore = [(re.compile(p), why) for p, why in ignore]
        self.aliases = [(re.compile(p), t) for p, t in aliases]
        self._ref = [(_prefix(r.ref), _pattern(r.ref), r) for r in self.rules]
        self._port = [(_prefix(p), _pattern(p), r, i) for r in self.rules
                      for i, p in enumerate(r.ports)]

    def __add__(self, other: "KeyMap") -> "KeyMap":
        km = KeyMap(self.rules + other.rules)
        km.ignore, km.aliases = self.ignore + other.ignore, self.aliases + other.aliases
        return km

    def prefixed(self, ref: str = "", port: str = "") -> "KeyMap":
        """The same map with `ref` before every reference key and `port`
        before every port name."""
        rules = [Rule(ref + r.ref, tuple(port + p for p in r.ports) if isinstance(r.port, tuple)
                      else port + r.port, r.fwd, r.bwd) for r in self.rules]
        km = KeyMap(rules)
        km.ignore = [(re.compile(re.escape(ref) + p.pattern), why) for p, why in self.ignore]
        km.aliases = [(re.compile(re.escape(ref) + p.pattern), ref + t) for p, t in self.aliases]
        return km

    def _match_ref(self, key: str):
        for pre, pat, rule in self._ref:
            if key.startswith(pre):
                m = pat.fullmatch(key)
                if m:
                    return rule, m.groupdict()
        return None

    def _resolve_aliases(self, sd: Dict[str, torch.Tensor], what: str) -> Dict[str, torch.Tensor]:
        """Rename each key through the aliases, in order; where two keys
        land on one name, the one renamed fewer times (the module's own
        key) is read and the other, the same shared tensor, is not."""
        best: Dict[str, Tuple[int, str]] = {}
        for key in sd:
            name, hops = key, 0
            for pat, target in self.aliases:
                m = pat.fullmatch(name)
                if m:
                    name, hops = m.expand(target), hops + 1
            if name in best and best[name][0] == hops:
                raise KeyError(f"{what}: {best[name][1]} and {key} both stand for {name}")
            if name not in best or hops < best[name][0]:
                best[name] = (hops, key)
        return {name: sd[key] for name, (_, key) in best.items()}

    def to_port(self, sd: Dict[str, torch.Tensor],
                what: str = "checkpoint") -> Dict[str, torch.Tensor]:
        """{port name: tensor} for every key of `sd` a rule takes; a key that
        no rule takes and no ignore entry names raises `KeyError`. Tensors
        keep their file dtype."""
        if self.aliases:
            sd = self._resolve_aliases(sd, what)
        out: Dict[str, torch.Tensor] = {}
        unknown = []
        for key, tensor in sd.items():
            hit = self._match_ref(key)
            if hit is None:
                if not any(pat.fullmatch(key) for pat, _ in self.ignore):
                    unknown.append(key)
                continue
            rule, groups = hit
            t = rule.fwd(tensor) if rule.fwd is not None else tensor
            names = [p.format(**groups) for p in rule.ports]
            parts = t.chunk(len(names), dim=0) if len(names) > 1 else (t,)
            for name, part in zip(names, parts):
                if name in out:
                    raise KeyError(f"{what}: two reference keys map to {name} (one is {key})")
                out[name] = part
        if unknown:
            raise KeyError(f"{what}: {len(unknown)} reference keys have no counterpart in the "
                           f"port and are not on its ignore list, e.g. {sorted(unknown)[:8]}")
        return out

    def to_ref(self, named: Dict[str, torch.Tensor], what: str = "module") -> Dict[str, torch.Tensor]:
        """The inverse of `to_port`: port tensors under the reference's keys.
        A port name that no rule covers raises `KeyError`."""
        found: Dict[Tuple[int, Tuple], Dict[int, torch.Tensor]] = {}
        keys: Dict[Tuple[int, Tuple], Tuple[Rule, dict]] = {}
        unknown = []
        for name, tensor in named.items():
            for pre, pat, rule, i in self._port:
                if name.startswith(pre):
                    m = pat.fullmatch(name)
                    if m:
                        groups = m.groupdict()
                        k = (id(rule), tuple(sorted(groups.items())))
                        found.setdefault(k, {})[i] = tensor
                        keys[k] = (rule, groups)
                        break
            else:
                unknown.append(name)
        if unknown:
            raise KeyError(f"{what}: {len(unknown)} port parameters have no reference key, "
                           f"e.g. {unknown[:8]}")
        out = {}
        for k, parts in found.items():
            rule, groups = keys[k]
            if len(parts) != len(rule.ports):
                raise KeyError(f"{what}: {rule.ref.format(**groups)} needs all of {rule.ports}")
            t = torch.cat([parts[i] for i in range(len(parts))]) if len(parts) > 1 else parts[0]
            out[rule.ref.format(**groups)] = rule.bwd(t) if rule.bwd is not None else t
        return out


def transpose(t: torch.Tensor) -> torch.Tensor:
    """(in, out) ↔ (out, in): HF GPT-2's Conv1D against `nn.Linear`."""
    return t.t()


@torch.no_grad()
def load_module(module: torch.nn.Module, tensors: Dict[str, torch.Tensor], what: str,
                times: Optional[Dict[str, float]] = None) -> torch.nn.Module:
    """Copy `tensors` (port names relative to `module`) into its
    parameters, strictly: a parameter left unset, a tensor with no
    parameter, or a shape that differs raises. Each tensor moves to the
    parameter's device in its file dtype and is cast there. `times`
    accumulates the seconds of the moves ("read") and of the casts
    ("cast"), with a device sync at the end."""
    params = dict(module.named_parameters())
    missing = sorted(params.keys() - tensors.keys())
    extra = sorted(tensors.keys() - params.keys())
    if missing:
        raise KeyError(f"{what}: the checkpoint leaves {len(missing)} parameters unset, "
                       f"e.g. {missing[:8]}")
    if extra:
        raise KeyError(f"{what}: {len(extra)} mapped tensors have no parameter, e.g. {extra[:8]}")
    read = cast = 0.0
    for name, p in params.items():
        src = tensors[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{what}.{name}: checkpoint shape {tuple(src.shape)} != "
                             f"module shape {tuple(p.shape)}")
        t0 = time.perf_counter()
        staged = src.to(p.device)
        t1 = time.perf_counter()
        p.copy_(staged)
        cast += time.perf_counter() - t1
        read += t1 - t0
    if times is not None:
        t0 = time.perf_counter()
        dev = next(iter(params.values())).device if params else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times["read"] = times.get("read", 0.0) + read
        times["cast"] = times.get("cast", 0.0) + cast + time.perf_counter() - t0
    return module

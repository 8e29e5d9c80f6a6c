"""Key maps between a published checkpoint's keys and the reference's
parameter names, one per model: `to_port` reads a published state dict
into the reference's names (the name is kept from the code it was frozen
from), `to_ref` writes the other way."""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

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
    read, such as buffers it recomputes."""

    def __init__(self, rules: Iterable[Rule], ignore: Sequence[Tuple[str, str]] = ()):
        self.rules = list(rules)
        self.ignore = [(re.compile(p), why) for p, why in ignore]
        self._ref = [(_prefix(r.ref), _pattern(r.ref), r) for r in self.rules]
        self._port = [(_prefix(p), _pattern(p), r, i) for r in self.rules
                      for i, p in enumerate(r.ports)]

    def __add__(self, other: "KeyMap") -> "KeyMap":
        km = KeyMap(self.rules + other.rules)
        km.ignore = self.ignore + other.ignore
        return km

    def prefixed(self, ref: str = "", port: str = "") -> "KeyMap":
        """The same map with `ref` before every reference key and `port`
        before every port name."""
        rules = [Rule(ref + r.ref, tuple(port + p for p in r.ports) if isinstance(r.port, tuple)
                      else port + r.port, r.fwd, r.bwd) for r in self.rules]
        km = KeyMap(rules)
        km.ignore = [(re.compile(re.escape(ref) + p.pattern), why) for p, why in self.ignore]
        return km

    def _match_ref(self, key: str):
        for pre, pat, rule in self._ref:
            if key.startswith(pre):
                m = pat.fullmatch(key)
                if m:
                    return rule, m.groupdict()
        return None

    def to_port(self, sd: Dict[str, torch.Tensor],
                what: str = "checkpoint") -> Dict[str, torch.Tensor]:
        """{port name: tensor} for every key of `sd` a rule takes; a key that
        no rule takes and no ignore entry names raises `KeyError`. Tensors
        keep their file dtype."""
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


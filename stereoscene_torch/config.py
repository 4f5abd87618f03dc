"""Config-as-python with ``_base_`` inheritance, port of
``stereoscene_tpu/config.py`` (a copy: the port imports nothing of the JAX
package).

Keeps the reference's config surface (mmcv-style python files with the same
key names as configs/occupancy/semantickitti/stereoscene.py) so existing
configs translate unchanged, without depending on mmcv: a config file is
executed in an isolated namespace; ``_base_`` lists parent configs (paths
relative to the child) whose dicts are recursively merged, child keys
winning (ref: tools/train.py:107 Config.fromfile + mmcv merge semantics).
The port's configs live in ``stereoscene_torch/configs/``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict


def _merge(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, val in child.items():
        if (
            key in out
            and isinstance(out[key], dict)
            and isinstance(val, dict)
            and not val.get("_delete_", False)
        ):
            out[key] = _merge(out[key], val)
        else:
            val = copy.deepcopy(val)
            if isinstance(val, dict):
                val.pop("_delete_", None)
            out[key] = val
    return out


def load_config(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    namespace: Dict[str, Any] = {"__file__": path}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), namespace)

    cfg = {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }

    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_cfg = load_config(os.path.join(os.path.dirname(path), base))
        merged = _merge(merged, base_cfg)
    return _merge(merged, cfg)


def _parse_option_value(text: str) -> Any:
    """mmcv DictAction value semantics: literal python where possible,
    'true'/'false'/'none' keywords, and top-level commas building a tuple
    (ref: tools/train.py:69-78 --cfg-options help text)."""
    import ast

    text = text.strip()
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    # top-level comma list (respecting brackets/parens)
    depth, parts, cur = 0, [], []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if parts:
        parts.append("".join(cur))
        return tuple(_parse_option_value(p) for p in parts)
    return text


def merge_from_options(cfg: Dict[str, Any], options: Dict[str, Any] | list):
    """Deep-override config entries from ``key.path=value`` options.

    Mirrors mmcv's ``Config.merge_from_dict`` used by the reference's
    ``--cfg-options`` (ref: tools/train.py:69-78, 107-110): dotted keys walk
    nested dicts (creating them as needed); integer path segments index into
    lists/tuples. ``options`` may be a dict {key: value} or a list of
    ``"key=value"`` strings (values parsed like mmcv DictAction).
    """
    if isinstance(options, (list, tuple)):
        parsed = {}
        for item in options:
            if "=" not in item:
                raise ValueError(f"--cfg-options entry needs key=value: {item}")
            k, v = item.split("=", 1)
            parsed[k] = _parse_option_value(v)
        options = parsed

    for key, value in options.items():
        parts = key.split(".")
        node = cfg
        for i, part in enumerate(parts[:-1]):
            if isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                if part not in node or not isinstance(
                    node[part], (dict, list, tuple)
                ):
                    node[part] = {}
                node = node[part]
        last = parts[-1]
        if isinstance(node, list) and last.lstrip("-").isdigit():
            node[int(last)] = value
        else:
            node[last] = value
    return cfg


class Config(dict):
    """Attribute-style access over the plain config dict."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) else v

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        return cls(load_config(path))

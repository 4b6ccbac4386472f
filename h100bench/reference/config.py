"""Input-deck parameter system.

Parses the same ``<block/subblock> key = value`` INI dialect as the reference
(Parthenon's ``ParameterInput``; see e.g.
``inputs/linwave/linear_wave.in``) so that reference decks run verbatim:

* ``<block>`` headers, ``key = value   # comment`` pairs
* ``&`` line-continuation (used for multi-line ``variables =`` lists)
* command-line overrides ``block/sub/key=value`` appended after the deck
* ``GetOrAdd*`` point-of-use defaults, ``CheckRequired`` for mandatory keys

This is a ground-up reimplementation in Python; only the file format is shared.

Copied from ``artemis_tpu/config.py`` with the code unchanged (it needs
only the standard library), so that ``artemis_tpu_torch`` runs where JAX
is not installed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional


class ParameterError(RuntimeError):
    pass


def _parse_scalar(s: str) -> str:
    return s.strip()


class ParameterInput:
    """Nested-block parameter store with GetOrAdd semantics."""

    def __init__(self) -> None:
        # blocks['parthenon/mesh']['nx1'] = '128'
        self.blocks: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------------ parse
    @classmethod
    def from_string(cls, text: str) -> "ParameterInput":
        pin = cls()
        pin.update_from_string(text)
        return pin

    @classmethod
    def from_file(cls, path: str) -> "ParameterInput":
        with open(path, "r") as f:
            return cls.from_string(f.read())

    def update_from_string(self, text: str) -> None:
        block = None
        # join continuation lines ending with '&'
        logical_lines = []
        pending = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if line.rstrip().endswith("&"):
                pending += line.rstrip()[:-1]
                continue
            logical_lines.append(pending + line)
            pending = ""
        if pending:
            logical_lines.append(pending)

        for line in logical_lines:
            line = line.strip()
            m = re.match(r"^<([^>]+)>$", line)
            if m:
                block = m.group(1).strip()
                self.blocks.setdefault(block, {})
                continue
            if "=" in line:
                if block is None:
                    raise ParameterError(f"key=value outside block: {line!r}")
                key, val = line.split("=", 1)
                self.blocks[block][key.strip()] = _parse_scalar(val)
            else:
                raise ParameterError(f"cannot parse deck line: {line!r}")

    def apply_overrides(self, overrides) -> None:
        """Apply CLI-style ``block/sub/key=value`` overrides."""
        for ov in overrides:
            if "=" not in ov:
                raise ParameterError(f"bad override: {ov!r}")
            path, val = ov.split("=", 1)
            parts = path.split("/")
            block, key = "/".join(parts[:-1]), parts[-1]
            if not block:
                raise ParameterError(f"override missing block: {ov!r}")
            self.blocks.setdefault(block, {})[key.strip()] = _parse_scalar(val)

    # ------------------------------------------------------------------ query
    def has_block(self, block: str) -> bool:
        return block in self.blocks

    def block_names(self):
        return list(self.blocks)

    def exists(self, block: str, key: str) -> bool:
        return block in self.blocks and key in self.blocks[block]

    def check_required(self, block: str, key: str) -> None:
        if not self.exists(block, key):
            raise ParameterError(f"missing required parameter <{block}> {key}")

    def _get_raw(self, block: str, key: str) -> str:
        try:
            return self.blocks[block][key]
        except KeyError:
            raise ParameterError(f"parameter <{block}> {key} not found") from None

    def set(self, block: str, key: str, value: Any) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self.blocks.setdefault(block, {})[key] = str(value)

    # typed getters -----------------------------------------------------
    def get_str(self, block: str, key: str) -> str:
        return self._get_raw(block, key)

    def get_real(self, block: str, key: str) -> float:
        return float(self._get_raw(block, key))

    def get_int(self, block: str, key: str) -> int:
        return int(float(self._get_raw(block, key)))

    def get_bool(self, block: str, key: str) -> bool:
        v = self._get_raw(block, key).lower()
        if v in ("true", "t", "1", "yes", "on"):
            return True
        if v in ("false", "f", "0", "no", "off"):
            return False
        raise ParameterError(f"cannot parse bool <{block}> {key} = {v!r}")

    # GetOrAdd: reads the key, inserting the default if absent (so later
    # readers observe the same value, as in the reference).
    def get_or_add_str(self, block: str, key: str, default: str) -> str:
        if not self.exists(block, key):
            self.set(block, key, default)
        return self.get_str(block, key)

    def get_or_add_real(self, block: str, key: str, default: float) -> float:
        if not self.exists(block, key):
            self.set(block, key, repr(float(default)))
        return self.get_real(block, key)

    def get_or_add_int(self, block: str, key: str, default: int) -> int:
        if not self.exists(block, key):
            self.set(block, key, str(int(default)))
        return self.get_int(block, key)

    def get_or_add_bool(self, block: str, key: str, default: bool) -> bool:
        if not self.exists(block, key):
            self.set(block, key, default)
        return self.get_bool(block, key)

    # list getters (comma-separated values)
    def get_list(self, block: str, key: str):
        return [s.strip() for s in self._get_raw(block, key).split(",") if s.strip()]

    def get_real_list(self, block: str, key: str):
        return [float(s) for s in self.get_list(block, key)]

    def __repr__(self) -> str:  # pragma: no cover
        out = []
        for b, kv in self.blocks.items():
            out.append(f"<{b}>")
            for k, v in kv.items():
                out.append(f"  {k} = {v}")
        return "\n".join(out)

"""Value codec — stable bytes <-> values for stored data.

Reference: jepsen/src/jepsen/codec.clj — edn <-> byte arrays, used by
suites to serialize operation values into databases (e.g. queue payloads).
JSON plays edn's role here.
"""

from __future__ import annotations

import json
from typing import Any


def encode(value: Any) -> bytes:
    """Value -> bytes (codec.clj encode); None -> empty, like nil."""
    if value is None:
        return b""
    return json.dumps(value, separators=(",", ":"),
                      sort_keys=True).encode()


def decode(data: bytes | None) -> Any:
    """Bytes -> value (codec.clj decode); empty -> None."""
    if not data:
        return None
    if isinstance(data, (bytes, bytearray)):
        data = data.decode()
    return json.loads(data)

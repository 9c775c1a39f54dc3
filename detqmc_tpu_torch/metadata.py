"""Run metadata (`info.dat`) read/write.

Reference parity: SURVEY.md §3 row "Metadata" (src/metadata.h —
Metadata = map<string,string>, readOnlyMetadata / writeOnlyMetaData).
The file contract matches the reference's `info.dat`: one `key = value`
per line, '#' comments, all simulation parameters plus progress counters —
the de-facto run manifest consumed by the offline analysis tools. The
port's own copy of detqmc_tpu/metadata.py: the same file format.
"""

from __future__ import annotations

import os
from typing import Dict

Metadata = Dict[str, str]


def metadata_to_string(meta: Metadata, prefix: str = "") -> str:
    lines = [f"{prefix}{k} = {v}" for k, v in meta.items()]
    return "\n".join(lines) + "\n"


def string_to_metadata(text: str) -> Metadata:
    meta: Metadata = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        meta[key.strip().lstrip("#").strip()] = value.strip()
    return meta


def write_metadata(path: str | os.PathLike, meta: Metadata) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(metadata_to_string(meta))
    os.replace(tmp, path)  # atomic-ish, like the reference's save pattern


def read_metadata(path: str | os.PathLike) -> Metadata:
    with open(path) as f:
        return string_to_metadata(f.read())

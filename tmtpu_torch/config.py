"""The daemon's settings from its home: ``<home>/config/config.toml``.

The port's own reader of what ``python -m tmtpu sidecar`` takes from that
file (the reference loads the whole config, ``tmtpu/config/toml.py``): the
``[sidecar]`` section and the ``[crypto]`` keys the daemon applies (the
signature cache and the failure threshold of its health signal). Missing
keys keep the reference's defaults (``tmtpu/config/config.py``), among them
the 10 s request deadline; a file that is absent gives the defaults. Every
field takes the reference's environment override,
``TMTPU_<SECTION>_<FIELD>`` (``TMTPU_SIDECAR_ADDR``, ``TMTPU_CRYPTO_SIGCACHE_SHARDS``),
converted by the type of its default. ``load`` raises ``ValueError`` on
what the reference's ``validate`` rejects in these sections, and on a key
of ``[sidecar]`` it does not know, as the reference does; the other
sections belong to the node and are not read.

``mesh_devices`` and ``shard_min_lanes`` are read and validated but never
applied: ``tmtpu init`` writes them into every file, and the reader
rejects unknown keys, but the port's daemon serves one card and has no
split across cards.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any, Dict

MS = 1_000_000  # nanoseconds


@dataclasses.dataclass
class SidecarSettings:
    """The ``[sidecar]`` section, with the reference's defaults."""

    addr: str = ""
    backend: str = "auto"
    connect_timeout_ns: int = 2000 * MS
    request_deadline_ns: int = 10_000 * MS
    retry_backoff_ns: int = 1000 * MS
    breaker_failure_threshold: int = 3
    max_queue_lanes: int = 65536
    max_lanes_per_dispatch: int = 40960
    max_frame_bytes: int = 8 * 1024 * 1024
    warm_on_start: bool = True
    health_laddr: str = ""
    mesh_devices: int = 0      # read and validated, never applied
    shard_min_lanes: int = 2048  # likewise


@dataclasses.dataclass
class CryptoSettings:
    """The ``[crypto]`` keys the daemon applies."""

    breaker_failure_threshold: int = 3
    sigcache_enable: bool = True
    sigcache_max_entries: int = 131072
    sigcache_shards: int = 16


@dataclasses.dataclass
class Settings:
    sidecar: SidecarSettings = dataclasses.field(default_factory=SidecarSettings)
    crypto: CryptoSettings = dataclasses.field(default_factory=CryptoSettings)
    crypto_backend: str = "auto"  # the file's top-level key, for one check


def config_path(home: str) -> str:
    return os.path.join(os.path.expanduser(home), "config", "config.toml")


def _env_value(raw: str, default: Any) -> Any:
    """An override's text as the reference converts it, by the default's type."""
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    return raw


def _apply(obj, section: str, values: Dict[str, Any], strict: bool) -> None:
    known = {f.name for f in dataclasses.fields(obj)}
    for key, value in values.items():
        if key in known:
            setattr(obj, key, value)
        elif strict:
            raise ValueError(f"unknown key {section}.{key!r}")
    for key in known:
        raw = os.environ.get(f"TMTPU_{section.upper()}_{key.upper()}")
        if raw is not None:
            setattr(obj, key, _env_value(raw, getattr(obj, key)))


def validate(s: Settings) -> None:
    """The reference's ``validate`` rows for these keys."""
    sc, cr = s.sidecar, s.crypto
    if cr.breaker_failure_threshold < 1:
        raise ValueError("crypto.breaker_failure_threshold must be >= 1")
    if cr.sigcache_max_entries < 1:
        raise ValueError("crypto.sigcache_max_entries must be >= 1")
    if cr.sigcache_shards < 1:
        raise ValueError("crypto.sigcache_shards must be >= 1")
    if sc.mesh_devices < 0:
        raise ValueError("sidecar.mesh_devices cannot be negative (0 = all visible devices)")
    if sc.shard_min_lanes < 1:
        raise ValueError("sidecar.shard_min_lanes must be >= 1")
    if sc.backend not in ("auto", "cpu", "tpu"):
        raise ValueError(f"sidecar.backend must be auto/cpu/tpu, got {sc.backend!r}")
    if sc.addr and not sc.addr.startswith(("unix://", "tcp://")):
        raise ValueError(f"sidecar.addr must be unix:// or tcp://, got {sc.addr!r}")
    if sc.connect_timeout_ns <= 0 or sc.request_deadline_ns <= 0:
        raise ValueError("sidecar timeouts must be positive")
    if sc.retry_backoff_ns < 0:
        raise ValueError("sidecar.retry_backoff_ns cannot be negative")
    if sc.breaker_failure_threshold < 1:
        raise ValueError("sidecar.breaker_failure_threshold must be >= 1")
    if sc.max_queue_lanes < 1 or sc.max_lanes_per_dispatch < 1:
        raise ValueError("sidecar lane caps must be >= 1")
    if sc.max_frame_bytes < 4096:
        raise ValueError("sidecar.max_frame_bytes must be >= 4096")
    if s.crypto_backend == "sidecar" and sc.max_frame_bytes < 1 << 16:
        raise ValueError("sidecar.max_frame_bytes too small for crypto_backend=sidecar "
                         "(needs >= 65536)")


def load(home: str) -> Settings:
    """The settings of ``home``: its ``config/config.toml`` if there is one,
    else the defaults, then the environment's overrides, validated."""
    data: Dict[str, Any] = {}
    path = config_path(home)
    if os.path.exists(path):
        with open(path, "rb") as fh:
            data = tomllib.load(fh)
    s = Settings()
    s.crypto_backend = data.get("crypto_backend", s.crypto_backend)
    raw = os.environ.get("TMTPU_BASE_CRYPTO_BACKEND")
    if raw is not None:
        s.crypto_backend = raw
    _apply(s.sidecar, "sidecar", data.get("sidecar", {}), strict=True)
    _apply(s.crypto, "crypto", data.get("crypto", {}), strict=False)
    validate(s)
    return s

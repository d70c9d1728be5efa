"""The port's daemon reads its home's config.toml as the reference's does:
``tmtpu_torch/config.py`` against ``tmtpu.config.toml.load_config`` on files
written by the reference's own writer, with and without the
``TMTPU_<SECTION>_<FIELD>`` overrides, and ``python -m tmtpu_torch sidecar
--home H`` (the plain versions, no warm-up) listening and limiting where the
file says, flags winning over it, and ``mesh_devices`` accepted but never
applied: the daemon serves one card."""

import dataclasses
import os
import subprocess
import sys

import pytest

from tmtpu.config import toml as ref_toml
from tmtpu.config.config import Config, CryptoConfig, SidecarConfig
from tmtpu.sidecar.client import SidecarClient
from tmtpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGCACHE_KEYS = ("sigcache_enable", "sigcache_max_entries", "sigcache_shards",
                 "breaker_failure_threshold")


def _write(home, edit=None) -> str:
    cfg = Config()
    if edit is not None:
        edit(cfg)
    path = os.path.join(home, "config", "config.toml")
    ref_toml.write_config(cfg, path)
    return path


def _same(home, path):
    """The port's reading of ``home`` and the reference's of ``path``."""
    ref = ref_toml.load_config(path)
    got = config.load(home)
    assert dataclasses.asdict(got.sidecar) == dataclasses.asdict(ref.sidecar)
    assert {k: getattr(got.crypto, k) for k in SIGCACHE_KEYS} == \
        {k: getattr(ref.crypto, k) for k in SIGCACHE_KEYS}
    return got


def _changed(cfg):
    sc, cr = cfg.sidecar, cfg.crypto
    sc.addr = "tcp://127.0.0.1:26999"
    sc.request_deadline_ns = 2_500_000_000
    sc.max_queue_lanes, sc.max_lanes_per_dispatch = 1000, 500
    sc.max_frame_bytes = 1 << 20
    sc.warm_on_start = False
    sc.health_laddr = "127.0.0.1:26998"
    sc.mesh_devices, sc.shard_min_lanes = 4, 64
    cr.sigcache_enable, cr.sigcache_max_entries, cr.sigcache_shards = False, 4096, 4
    cr.breaker_failure_threshold = 5


ENV = {"TMTPU_SIDECAR_ADDR": "unix:///run/sc.sock",
       "TMTPU_SIDECAR_MAX_QUEUE_LANES": "777",
       "TMTPU_SIDECAR_WARM_ON_START": "0",
       "TMTPU_SIDECAR_REQUEST_DEADLINE_NS": "3000000000",
       "TMTPU_SIDECAR_HEALTH_LADDR": "127.0.0.1:1",
       "TMTPU_CRYPTO_SIGCACHE_ENABLE": "false",
       "TMTPU_CRYPTO_SIGCACHE_SHARDS": "8"}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("TMTPU_"):
            monkeypatch.delenv(key)


@pytest.mark.parametrize("edit", [None, _changed], ids=["defaults", "changed"])
@pytest.mark.parametrize("env", [False, True], ids=["file", "env"])
def test_reader_matches_the_reference(tmp_path, monkeypatch, edit, env):
    path = _write(str(tmp_path), edit)
    if env:
        for k, v in ENV.items():
            monkeypatch.setenv(k, v)
    got = _same(str(tmp_path), path)
    if env:
        assert got.sidecar.addr == ENV["TMTPU_SIDECAR_ADDR"]
        assert got.crypto.sigcache_enable is False and got.sidecar.warm_on_start is False
    elif edit is None:
        assert got.sidecar.request_deadline_ns == 10_000_000_000


def test_no_file_gives_the_reference_defaults(tmp_path, monkeypatch):
    got = config.load(str(tmp_path))
    assert dataclasses.asdict(got.sidecar) == dataclasses.asdict(SidecarConfig())
    assert {k: getattr(got.crypto, k) for k in SIGCACHE_KEYS} == \
        {k: getattr(CryptoConfig(), k) for k in SIGCACHE_KEYS}
    monkeypatch.setenv("TMTPU_SIDECAR_MAX_LANES_PER_DISPATCH", "99")
    assert config.load(str(tmp_path)).sidecar.max_lanes_per_dispatch == 99


def _bad(section, key, value):
    def edit(cfg):
        setattr(getattr(cfg, section), key, value)
    return edit


BAD = {
    "addr": _bad("sidecar", "addr", "http://127.0.0.1:1"),
    "backend": _bad("sidecar", "backend", "sidecar"),
    "deadline": _bad("sidecar", "request_deadline_ns", 0),
    "connect": _bad("sidecar", "connect_timeout_ns", -1),
    "backoff": _bad("sidecar", "retry_backoff_ns", -1),
    "breaker": _bad("sidecar", "breaker_failure_threshold", 0),
    "queue": _bad("sidecar", "max_queue_lanes", 0),
    "lanes": _bad("sidecar", "max_lanes_per_dispatch", 0),
    "frame": _bad("sidecar", "max_frame_bytes", 4095),
    "mesh": _bad("sidecar", "mesh_devices", -1),
    "shard": _bad("sidecar", "shard_min_lanes", 0),
    "entries": _bad("crypto", "sigcache_max_entries", 0),
    "shards": _bad("crypto", "sigcache_shards", 0),
    "threshold": _bad("crypto", "breaker_failure_threshold", 0),
    "frame-for-sidecar": lambda cfg: (setattr(cfg.base, "crypto_backend", "sidecar"),
                                      setattr(cfg.sidecar, "max_frame_bytes", 32768)),
}


@pytest.mark.parametrize("edit", list(BAD.values()), ids=list(BAD))
def test_what_the_reference_rejects_raises(tmp_path, edit):
    path = _write(str(tmp_path), edit)
    with pytest.raises(ValueError) as ref_err:
        ref_toml.load_config(path)
    with pytest.raises(ValueError) as err:
        config.load(str(tmp_path))
    assert str(err.value) == str(ref_err.value)


def test_unknown_sidecar_key_raises_and_other_sections_are_not_read(tmp_path):
    path = _write(str(tmp_path))
    with open(path, "a") as fh:
        fh.write("\n[sidecar]\n")  # a second table: tomllib itself refuses it
    with pytest.raises(Exception):
        config.load(str(tmp_path))
    cfgdir = tmp_path / "other"
    (cfgdir / "config").mkdir(parents=True)
    (cfgdir / "config" / "config.toml").write_text(
        'moniker = "n"\n[p2p]\nladdr = "x"\n[sidecar]\nmax_lanes_per_dispatch = 5\n')
    assert config.load(str(cfgdir)).sidecar.max_lanes_per_dispatch == 5
    (cfgdir / "config" / "config.toml").write_text("[sidecar]\nlanes = 5\n")
    with pytest.raises(ValueError, match="unknown key sidecar"):
        config.load(str(cfgdir))


# --- the daemon with --home ------------------------------------------------------


class _Daemon:
    """``python -m tmtpu_torch sidecar --home H --device cpu --no-warm``."""

    def __init__(self, home, *args):
        env = {k: v for k, v in os.environ.items() if not k.startswith("TMTPU_")}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tmtpu_torch", "sidecar", "--home", str(home),
             "--device", "cpu", "--no-warm", *args],
            cwd=ROOT, env=dict(env, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.ready = self.proc.stdout.readline()
        assert self.ready.startswith("Sidecar listening on "), \
            self.ready + self.proc.stderr.read()
        self.addr = self.ready.split()[3]

    def stats(self):
        c = SidecarClient(self.addr, client_id="cfg", connect_timeout_s=10.0)
        try:
            return c.stats(), c.hello_ack
        finally:
            c.close()

    def stop(self):
        self.proc.terminate()
        out, err = self.proc.communicate(timeout=60)
        assert self.proc.returncode == 0, err


@pytest.fixture
def home(tmp_path):
    sock = tmp_path / "from-file.sock"

    def edit(cfg):
        cfg.sidecar.addr = f"unix://{sock}"
        cfg.sidecar.max_lanes_per_dispatch = 321
        cfg.sidecar.max_queue_lanes = 4321
        cfg.sidecar.request_deadline_ns = 4_000_000_000
        cfg.crypto.sigcache_enable = False
        cfg.crypto.breaker_failure_threshold = 7

    _write(str(tmp_path), edit)  # mesh_devices = 0, as `tmtpu init` writes it
    return tmp_path


def test_home_config_sets_address_limits_and_cache(home):
    d = _Daemon(home)
    try:
        assert d.addr == f"unix://{home / 'from-file.sock'}"
        assert "sigcache=off" in d.ready
        stats, ack = d.stats()
        assert ack.max_lanes == 321
        assert stats["limits"] == {"max_queue_lanes": 4321, "max_lanes_per_dispatch": 321,
                                   "max_frame_bytes": 8 * 1024 * 1024,
                                   "request_deadline_s": 4.0}
        assert stats["sigcache"]["enabled"] is False
        assert stats["engine"]["failure_threshold"] == 7
        # mesh_devices = 0 in the file (every chip, in the reference) is
        # accepted and not applied: the daemon serves one card
        assert "mesh" not in stats
    finally:
        d.stop()


def test_flags_beat_the_file(home, tmp_path):
    other = f"unix://{tmp_path / 'from-flag.sock'}"
    d = _Daemon(home, "--addr", other, "--max-lanes", "55", "--max-queue-lanes", "66",
                "--health-laddr", "127.0.0.1:0")
    try:
        assert d.addr == other and " health=127.0.0.1:" in d.ready
        stats, ack = d.stats()
        assert ack.max_lanes == 55
        assert stats["limits"]["max_queue_lanes"] == 66
        assert stats["limits"]["request_deadline_s"] == 4.0  # no flag: the file's
    finally:
        d.stop()


def test_no_file_uses_the_home_socket_and_ten_second_deadline(tmp_path):
    d = _Daemon(tmp_path)
    try:
        assert d.addr == f"unix://{tmp_path / 'data' / 'sidecar.sock'}"
        assert d.stats()[0]["limits"]["request_deadline_s"] == 10.0
    finally:
        d.stop()

"""Central configuration: the port's copy of the settings of
honours_tpu/utils/config.py that its codecs read.

The eight fields the port's engines read, the byte layers' levels
zlib_level, zstd_level, bzip2_level and lzma2_preset (engine/layers.py),
stall_threshold and stall_margin (engine/dstall.py, and through it
engine/dstall_drans.py; engine/stall_fz.py), dstall_threshold
(engine/stall_fz.py's dstall_fz_1500) and flats_step (engine/flats.py's
flat_uint_submin), with the JAX package's defaults and its environment
overrides: each field reads HTPU_<FIELD> (e.g. HTPU_STALL_THRESHOLD=200),
so a setting gives both packages the same bytes.  The JAX Config's
other fields set its host codecs and its own geometry, which the port
does not have.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # generic entropy layers (press/press.h:256-284)
    zlib_level: int = -1  # Z_DEFAULT_COMPRESSION
    zstd_level: int = 1
    bzip2_level: int = 9
    lzma2_preset: int = 6
    # stall segmentation (press/press.c:7763, 7913, 7772-7773)
    stall_threshold: int = 140
    dstall_threshold: int = 1500
    stall_margin: int = 20
    # flats partitioner step granularity (codecs/flats.py)
    flats_step: int = 64

    @classmethod
    def default(cls) -> "Config":
        """The defaults, each overridden by HTPU_<FIELD> where set."""
        cfg = cls()
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"HTPU_{f.name.upper()}")
            if env is not None:
                setattr(cfg, f.name, int(env))
        return cfg


_CONFIG = None


def get_config() -> Config:
    """The process's Config, read from the environment on first use."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.default()
    return _CONFIG

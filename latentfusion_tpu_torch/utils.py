"""Block-config strings (counterpart of ``latentfusion_tpu/utils``)."""
from __future__ import annotations


def _parse_block(s: str):
    return s if s in ("I", "U", "D") else int(s)


def parse_block_config(s: str, delimiter: str = ",", group_delimiter: str = ":"):
    """``'64,D,128:512,U,256'`` -> ((64, 'D', 128), (512, 'U', 256)).

    These strings are stored in checkpoints; they parse exactly as in the
    JAX package."""
    if s.lower() == "none" or len(s) == 0:
        return ()

    def parse(sec):
        return tuple(_parse_block(b) for b in sec.split(delimiter)) if sec else ()

    if group_delimiter in s:
        return tuple(parse(sec) for sec in s.split(group_delimiter))
    return parse(s)

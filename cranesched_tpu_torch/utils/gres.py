"""GRES key helpers and the ``--gres`` flag's parser, free of torch so
that the node plane (craned, supervisor) and the ``crane`` commands can
use them without loading it; ``ops/resources.py`` re-exports the key
helpers."""


def gres_key_str(pair) -> str:
    """Canonical wire form of a GRES (name, type) pair: "name:type"."""
    name, typ = pair
    return f"{name}:{typ}"


def gres_key_pair(key: str) -> tuple:
    """Inverse of gres_key_str."""
    name, _, typ = key.partition(":")
    return (name, typ)


def parse_gres(text: str) -> dict:
    """'gpu:a100:2,fpga::1' -> {"gpu:a100": 2, "fpga:": 1} (the
    ``--gres`` flag of ``craned_main`` and of the ``crane`` commands)."""
    out = {}
    for part in text.split(","):
        bits = part.split(":")
        if len(bits) == 3:
            name, typ, count = bits
        elif len(bits) == 2:
            name, count = bits
            typ = ""
        else:
            raise SystemExit(f"crane: bad --gres {part!r} "
                             "(use name[:type]:count)")
        try:
            n = int(count)
        except ValueError:
            raise SystemExit(f"crane: bad --gres count {count!r}")
        if n < 1:
            raise SystemExit(f"crane: --gres count must be >= 1, "
                             f"got {n}")
        out[f"{name}:{typ}"] = n
    return out

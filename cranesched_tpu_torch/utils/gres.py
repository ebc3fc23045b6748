"""GRES key helpers, free of torch so that the node plane (craned,
supervisor) can use them without loading it; ``ops/resources.py``
re-exports both."""


def gres_key_str(pair) -> str:
    """Canonical wire form of a GRES (name, type) pair: "name:type"."""
    name, typ = pair
    return f"{name}:{typ}"


def gres_key_pair(key: str) -> tuple:
    """Inverse of gres_key_str."""
    name, _, typ = key.partition(":")
    return (name, typ)

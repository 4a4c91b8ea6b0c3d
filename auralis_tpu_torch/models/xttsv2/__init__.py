from ..registry import register_model


def _load_xtts(path: str, **kwargs):
    from .engine import XTTSv2Engine

    return XTTSv2Engine.from_pretrained(path, **kwargs)


register_model("xtts", _load_xtts)

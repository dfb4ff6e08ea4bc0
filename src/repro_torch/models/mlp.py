"""Dense feed-forward blocks (gated SwiGLU-style and plain GELU MLP)."""
from __future__ import annotations

from repro_torch.models.common import ParamSpec, act_fn


def mlp_spec(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.gated_mlp:
        return {
            "w_gate": ParamSpec((d, ff), ("d_model", "ffn")),
            "w_in": ParamSpec((d, ff), ("d_model", "ffn")),
            "w_out": ParamSpec((ff, d), ("ffn", "d_model")),
        }
    return {
        "w_in": ParamSpec((d, ff), ("d_model", "ffn")),
        "b_in": ParamSpec((ff,), ("ffn",), "zeros"),
        "w_out": ParamSpec((ff, d), ("ffn", "d_model")),
        "b_out": ParamSpec((d,), ("d_model",), "zeros"),
    }


def mlp_apply(w, x, cfg, tp=None):
    """Weights are cast to the compute dtype at each use.  With the ffn
    dim split over the model axis (``tp.ffn``): ``w_in`` / ``w_gate`` /
    ``b_in`` are this rank's columns, ``w_out`` its rows; the partial
    output is summed over the group and ``b_out`` added once, after."""
    dt = x.dtype
    act = act_fn(cfg.act)
    split = tp is not None and tp.ffn
    if split:
        x = tp.copy_in(x)
    if "w_gate" in w:
        h = act(x @ w["w_gate"].to(dt)) * (x @ w["w_in"].to(dt))
        y = h @ w["w_out"].to(dt)
        return tp.reduce(y) if split else y
    h = act(x @ w["w_in"].to(dt) + w["b_in"].to(dt))
    y = h @ w["w_out"].to(dt)
    return (tp.reduce(y) if split else y) + w["b_out"].to(dt)

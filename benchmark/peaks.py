"""Published peaks of the cards a cell may run on, by the name
``torch.cuda.get_device_name()`` gives. A card not listed has no
roofline: its readers return nothing.

NVIDIA H100 SXM5 (80 GB HBM3): 3.35 TB/s of HBM bandwidth, NVIDIA's data
sheet, at its full 700 W power limit.
"""

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str):
    return HBM_BYTES_PER_S.get(kind)


def roofline_percent(ctx, nbytes: int, seconds: float):
    """100 x the least time the card's HBM needs for ``nbytes`` over the
    ``seconds`` the device took; None where there is nothing to read or
    the card has no listed peak."""
    bw = hbm_bytes_per_s(ctx.device_kind)
    if bw is None or not nbytes or seconds <= 0:
        return None
    return 100.0 * nbytes / bw / seconds

"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``KERNELS`` maps a kernel's name to its wrapper (or, for the merge
kernel that K5 and K7 share, to the count of launches without and with a
payload); each counts its launches in ``.launches`` (CPU calls run the
plain version and do not count)."""

from zotpu_torch.kernels import merge_runs
from zotpu_torch.kernels.join import row_hits_sorted_join, row_hits_tagged
from zotpu_torch.kernels.merge_dedup import merge_dedup_pair
from zotpu_torch.kernels.merge_fused import set_op_fused
from zotpu_torch.kernels.pack import pack_canonical, pack_canonical_wire
from zotpu_torch.kernels.sortdedup import dedup_compact

KERNELS = {
    "pack_canonical_wire": pack_canonical_wire,
    "pack_canonical": pack_canonical,
    "dedup_compact": dedup_compact,
    "set_op_fused": set_op_fused,
    "join_row_hits": row_hits_sorted_join,
    "join_row_hits_tagged": row_hits_tagged,
    "merge_runs": merge_runs.KEYS_ONLY,
    "merge_dedup": merge_dedup_pair,
    "merge_runs_payload": merge_runs.WITH_PAYLOAD,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}

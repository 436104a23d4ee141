"""Several devices: the row-band pipeline over ``torch.distributed``.

Counterpart of ``mystereomatching_tpu/parallel`` for the three ported
presets: image rows split into bands over a 'row' axis of ranks and pairs
over a 'data' axis, one process a rank; halo exchange for the windowed
stages and a chunked wavefront for the vertical and diagonal SGM scans,
point to point. NCCL where every rank has a card of its own, gloo on the
CPU and where ranks share a card.
"""

from mystereomatching_tpu_torch.parallel.launch import run_row_bands
from mystereomatching_tpu_torch.parallel.sharded import check_sharded_support

__all__ = ["run_row_bands", "check_sharded_support"]

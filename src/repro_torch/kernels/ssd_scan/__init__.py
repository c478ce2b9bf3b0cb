from repro_torch.kernels.ssd_scan.kernel import MAX_CHUNK, STATE_SIZES, ssd_scan
from repro_torch.kernels.ssd_scan.ops import scan_route, ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["MAX_CHUNK", "STATE_SIZES", "ssd_scan", "scan_route", "ssd_scan_op",
           "ssd_scan_ref"]

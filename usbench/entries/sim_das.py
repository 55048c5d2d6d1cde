"""sim_das: ``us.greens(scatterers, **greens)`` (FSA echoes, then the
sequence's plane waves by ``focusTx``; ``greens`` the traffic's keyword
arguments), then ``us.DAS(chd)``, the image copied to the host.

The control is the program on its own lower-precision path: the
simulator's GEMM operands at the traffic's ``control`` precision."""
import numpy as np
from torch.profiler import record_function


def request_fn(cfg: dict, trf: dict, us, device, greens_precision: str = "highest"):
    import qups_tpu_torch as q

    kw = dict(method=cfg["sampler"], precision=cfg["precision"], device=device)
    gkw = dict(trf.get("greens", {}), precision=greens_precision, device=device)
    n = int(cfg["transducer"]["numel"])

    def request(x, calls):
        scat = q.Scatterers(pos=x["pos"].T.astype(np.float64),
                            amp=x["amp"].astype(np.float64), c0=float(cfg["c0"]))
        calls.greens_call(x["pos"], n, n)
        with record_function("usbench.entry"):
            chd = us.greens(scat, **gkw)
            calls.das_call(cfg, chd.data, 0.0)
            img = us.DAS(chd, **kw)
        with record_function("usbench.to_host"):
            return img.cpu()

    return request


def control(cfg: dict, trf: dict, x, idx: np.ndarray, device) -> np.ndarray:
    """The control's image (K, F) of cloud ``x`` at flat pixel indices ``idx``."""
    from usbench import traffic

    request = request_fn(cfg, trf, traffic.build_system(cfg), device,
                         greens_precision=trf["control"])
    return request(x, traffic.Calls()).numpy().reshape(-1, traffic.frames(trf))[idx]

"""das_rf: ``us.DAS(chd)`` on the RF traces, the image copied to the host."""
from torch.profiler import record_function


def request_fn(cfg: dict, trf: dict, us, device):
    import qups_tpu_torch as q

    fs, t0 = float(cfg["fs"]), float(cfg["t0"])
    kw = dict(method=cfg["sampler"], precision=cfg["precision"], device=device)

    def request(x, calls):
        chd = q.ChannelData(data=x, fs=fs, t0=t0)
        calls.das_call(cfg, chd.data, 0.0)
        with record_function("usbench.entry"):
            img = us.DAS(chd, **kw)
        with record_function("usbench.to_host"):
            return img.cpu()

    return request

"""das_iq: ``chd.hilbert().downmix(fc)`` on the RF traces, then
``us.DAS(iq, fmod=fc)``, the image copied to the host."""
from torch.profiler import record_function


def request_fn(cfg: dict, trf: dict, us, device):
    import qups_tpu_torch as q

    fs, t0 = float(cfg["fs"]), float(cfg["t0"])
    fc = float(cfg["transducer"]["fc"])
    kw = dict(method=cfg["sampler"], precision=cfg["precision"], device=device)

    def request(x, calls):
        chd = q.ChannelData(data=x, fs=fs, t0=t0)
        with record_function("usbench.dsp"):
            chd = chd.hilbert().downmix(fc)
        calls.das_call(cfg, chd.data, fc)
        with record_function("usbench.entry"):
            img = us.DAS(chd, fmod=fc, **kw)
        with record_function("usbench.to_host"):
            return img.cpu()

    return request

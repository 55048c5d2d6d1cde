"""channel_data.dsp_ms: device milliseconds a request of the DSP chain
(``ChannelData.hilbert``, ``downmix``): the device records run for the
benchmark's ``usbench.dsp`` range."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    us = tr.range_device_us("usbench.dsp")
    return None if not us else us * 1e-3 / len(run.requests)

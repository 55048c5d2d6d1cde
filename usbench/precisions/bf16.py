"""bfloat16 taps: each value (each part of a complex one) rounded to
bfloat16, round to nearest even, back in float64 / complex128."""
import torch


def round(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).double(),
                             x.imag.to(torch.bfloat16).double())
    return x.to(torch.bfloat16).double()

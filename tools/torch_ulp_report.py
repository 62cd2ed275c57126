"""ULP gaps between the PyTorch port and the JAX reference, per stage.

For each log / trig sampler stage, generates the same plan with the
port's "torch" backend and the reference's "xla" backend on the CPU and
prints the largest gap two ways: raw ULP (distance of the bit patterns)
and ``repro_torch.core.sampler.ulp_error`` (units of the spacing at
max(|x|, 1)), the measure the port's tests bound by 8.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_ulp_report.py
"""
import numpy as np
import torch

from repro.core import engine as j_engine
from repro_torch.core import engine, sampler

STAGES = ["normal", "exponential(1.5)", "gamma(2.5)", "gamma(1.0,2.0)",
          "gamma(3.0,0.5)", "gumbel"]
SHAPES = [(64, 256, 0), (256, 512, 2 ** 32 + 7)]


def _raw(x: torch.Tensor) -> np.ndarray:
    iv = torch.int32 if x.dtype == torch.float32 else torch.int16
    return x.view(iv).numpy().astype(np.int64)


def main() -> None:
    print("stage dtype T S | raw_ulp_max ulp_error_max")
    for spec in STAGES:
        for dtype in ("float32", "bfloat16"):
            for T, S, off in SHAPES:
                kw = dict(seed=11, num_streams=S, num_steps=T, offset=off,
                          sampler=spec, out_dtype=dtype)
                ref = np.asarray(j_engine.generate(j_engine.make_plan(**kw),
                                                   backend="xla"))
                got = engine.generate(engine.make_plan(device="cpu", **kw))
                want = torch.from_numpy(ref.astype(np.float32)).to(got.dtype)
                raw = int(np.abs(_raw(got) - _raw(want)).max())
                err = float(sampler.ulp_error(got, want).max())
                print(f"{spec} {dtype} {T} {S} | {raw} {err}")


if __name__ == "__main__":
    main()

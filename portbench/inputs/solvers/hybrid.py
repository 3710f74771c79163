"""``{"kind": "hybrid", "num_rays": n}``: the port's ``HybridPathTracer``, which picks each
order's candidates by visibility from ``n`` lattice rays a vertex."""


def make(spec: dict):
    from differt_tpu_torch.rt import HybridPathTracer

    return HybridPathTracer(num_rays=spec["num_rays"])

"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
`repro`; names are compared by their whole top-level part."""
import subprocess
import sys

from bench.lib import spec

sys.path.insert(0, str(spec.BENCH))
import run  # noqa: E402  (bench/run.py)


def test_names_compare_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "jaxtyping", "flaxen", "reprox"]) == []
    assert run.forbidden_modules(["repro.core.inl", "jax.numpy", "jaxlib",
                                  "flax.linen", "repro_torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_the_run_loads_no_jax():
    """A fresh process imports the harness, every driver, reference,
    metric and the port's modules the drivers reach, and finds nothing
    forbidden loaded."""
    probe = (
        "import sys\n"
        f"sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}, "
        f"{str(spec.BENCH)!r}]\n"
        "import run\n"
        "from bench.lib import harness, spec\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    c = spec.load_cell(w['name'])\n"
        "    spec.driver(c.traffic['driver']); spec.reference(c.config['reference'])\n"
        "    [spec.metric_reader(m['name']) for m in c.per_layer]\n"
        "import repro_torch.core.schemes, repro_torch.core.schemes.runner\n"
        "import repro_torch.core.inl_llm, repro_torch.launch.steps\n"
        "import repro_torch.data.prefetch, repro_torch.configs.base\n"
        "import repro_torch.configs.paper_inl\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

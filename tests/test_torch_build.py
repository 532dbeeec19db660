"""posfeat_tpu_torch.ops._build on the CPU: the stage tools' variant
builds, with a stand-in for nvcc that records what it was given."""

import sys

from posfeat_tpu_torch.ops import _build

# writes its argv and the first .cu file's text to the -o path, prints a log line
FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
cu = next(a for a in args if a.endswith(".cu"))
with open(out, "w") as f:
    f.write(repr(args) + "\\n" + open(cu).read())
print("ptxas info : built", out)
"""


def test_build_variants_compiles_each_rewritten_copy(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    out = _build.build_variants("reinforce.cu", ("full", "cut"),
                                lambda src, name: src if name == "full" else "// cut\n", tmp_path / "out")
    assert sorted(out) == ["cut", "full"]
    for name, (so, log) in out.items():
        assert f"built {so}" in log
        args, text = open(so).read().split("\n", 1)
        # the copy first, then the library's other sources as they are, with csrc on the include path
        assert args.endswith(f"'{tmp_path / 'out' / name}.cu', '{_build.PKG / 'csrc' / 'fused_head.cu'}']")
        assert f"'-I', '{_build.PKG / 'csrc'}'" in args and "'arch=compute_90a,code=sm_90a'" in args
    assert open(out["cut"][0]).read().split("\n", 1)[1] == "// cut\n"
    assert open(out["full"][0]).read().split("\n", 1)[1] == (_build.PKG / "csrc" / "reinforce.cu").read_text()

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
        others = ", ".join(f"'{src}'" for src in _build.SOURCES if src.name != "reinforce.cu")
        assert args.endswith(f"'{tmp_path / 'out' / name}.cu', {others}]")
        assert f"'-I', '{_build.PKG / 'csrc'}'" in args and "'arch=compute_90a,code=sm_90a'" in args
    assert open(out["cut"][0]).read().split("\n", 1)[1] == "// cut\n"
    assert open(out["full"][0]).read().split("\n", 1)[1] == (_build.PKG / "csrc" / "reinforce.cu").read_text()


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """``build`` starts one nvcc per source with -c (no -shared), then
    links the objects into the library, keeps every process's ptxas log,
    and removes the objects."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable).replace(
        'cu = next(a for a in args if a.endswith(".cu"))', 'cu = next(a for a in args if a.endswith((".cu", ".o")))'))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    info = _build.build(force=True)
    so = info["path"]
    assert so.parent == tmp_path / "build" and so.exists() and not list(so.parent.glob("*.o"))
    for src in _build.SOURCES:
        assert f"{so.stem}.{src.stem}." in info["log"]
    args = open(so).read().split("\n", 1)[0]
    assert "'-shared'" in args and "'-c'" not in args and args.count(".o'") == len(_build.SOURCES)
    assert so.with_suffix(".log").read_text() == info["log"]


C_TYPES = {"void*": "c_void_p", "const void*": "c_void_p", "int": "c_int", "long long": "c_longlong",
           "long": "c_long", "float": "c_float", "const char*": "c_char_p"}


class _Entry:
    """A stand-in for a ctypes function: keeps the argtypes and restype set on it."""


class _Lib:
    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry())


def test_bind_matches_the_c_declarations():
    """Every posfeat_* entry point of the sources is bound with one ctypes
    type per C parameter, in order, and its return type."""
    import ctypes
    import re

    lib = _Lib()
    _build.bind(lib)
    declared = {}
    for src in _build.SOURCES:
        for ret, name, params in re.findall(r"^(int|long|const char\*) (posfeat_\w+)\(([^)]*)\)", src.read_text(), re.M):
            types = [re.sub(r"\s+\w+$", "", p.strip()).replace(" *", "*") for p in params.split(",")]
            declared[name] = (C_TYPES[ret], [C_TYPES[t] for t in types])
    assert sorted(declared) == sorted(lib.entries)
    for name, (ret, args) in declared.items():
        entry = lib.entries[name]
        assert entry.restype is getattr(ctypes, ret), name
        assert list(entry.argtypes) == [getattr(ctypes, t) for t in args], name

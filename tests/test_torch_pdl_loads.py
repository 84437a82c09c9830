"""A source check over ``come_tpu_torch/csrc/``: how the kernels that run
under programmatic dependent launch (PDL) read what an earlier kernel of
their step wrote.

Such a kernel may start before the kernel ahead of it has finished, and its
``pdl_wait()`` is where that kernel's writes become visible.  A load
through a ``const ... __restrict__`` pointer may be compiled as an
invariant load, which the compiler is free to move above the wait, so a
kernel could read the last step's ``nt`` or table row.  The rule
(``csrc/sgns_common.cuh``'s note): no kernel that calls ``pdl_wait()``
takes a ``const ... __restrict__`` pointer, and it reads its const pointers
only through ``step_ld`` (ordinary loads, which the compiler keeps after
the wait) or through the row helpers, which use it.  An asynchronous copy
(``cp.async``, ``cp.async.bulk``, a TMA copy) reads global memory on its
own, so the same rule holds for it: a kernel that calls ``pdl_wait()``
issues no copy of a step-written buffer before the wait.  The CPU cannot
compile CUDA, so this holds the source; the card holds the results
(``chip_smoke.py``'s back-to-back phases).
"""

import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "come_tpu_torch" / "csrc"
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))

# the buffers an earlier kernel of a step writes (sgns_common.cuh's note),
# by the names the kernels give them
STEP_WRITTEN = {
    "table", "emb", "emb_in", "emb_out", "ids", "c", "x", "nt", "dphi",
    "dphin", "dneg", "cneg", "dctx", "dcpos", "stats", "pool", "pools",
    "walks", "wrow", "slots", "meta", "args", "info", "order",
}


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def _balanced(src: str, i: int, open_: str, close: str) -> int:
    """The index just past the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(src)):
        if src[j] == open_:
            depth += 1
        elif src[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    raise AssertionError("unbalanced source")


def kernels(src: str):
    """(name, parameter text, body text) of every __global__ function."""
    src = _strip_comments(src)
    out = []
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                         r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", src):
        name, p = m.group(1), m.end() - 1
        q = _balanced(src, p, "(", ")")
        b = src.index("{", q)
        out.append((name, src[p + 1:q - 1], src[b:_balanced(src, b, "{",
                                                            "}")]))
    return out


def _params(text: str):
    """(declaration, name) of each parameter."""
    out = []
    for decl in (d.strip() for d in text.split(",")):
        names = re.findall(r"(\w+)\s*$", decl)
        if names:
            out.append((decl, names[0]))
    return out


def pdl_kernels():
    found = []
    for path in SOURCES:
        for name, params, body in kernels(path.read_text()):
            if "pdl_wait()" in body:
                found.append((f"{path.name}:{name}", params, body))
    return found


def test_the_check_finds_the_pdl_kernels():
    names = {k.split(":")[1] for k, _, _ in pdl_kernels()}
    # every pass of every loop (the step's head kernels do not wait)
    for want in ("negative_f32_kernel", "negative_f32_wide_kernel",
                 "negative_bf16_kernel", "negative_bf16_wide_kernel",
                 "apply_pool_kernel", "apply_pool_bf16_kernel",
                 "stage_pool_kernel", "stage_pool_bf16_kernel",
                 "pool_chains_kernel", "slot_chains_kernel",
                 "fold_chains_kernel",
                 "walk_pos_kernel", "walk_pos_wide_kernel",
                 "walk_pos_slab_kernel", "walk_scatter_kernel",
                 "block_end_scatter_kernel",
                 "walk_scatter_bf16_kernel", "star_scatter_kernel",
                 "star_block_end_scatter_kernel",
                 "star_pos_kernel", "star_pos_wide_kernel",
                 "star_pos_slab_kernel",
                 "fused_pos_kernel", "fused_scatter_kernel",
                 "fused_apply_kernel"):
        assert want in names, want
    assert "step_head_kernel" not in names
    assert "fused_stage_kernel" not in names


@pytest.mark.parametrize("where,params,body", pdl_kernels(),
                         ids=[k for k, _, _ in pdl_kernels()])
def test_pdl_kernels_read_step_buffers_only_through_step_ld(where, params,
                                                            body):
    for decl, name in _params(params):
        const_ptr = decl.startswith("const") and "*" in decl
        assert not (const_ptr and "__restrict__" in decl), (
            f"{where}: {decl} is a const __restrict__ pointer")
        if const_ptr and name in STEP_WRITTEN:
            # read only through step_ld or a row helper: never
            # subscripted, never dereferenced
            assert not re.search(rf"(?<![\w.>]){name}\s*\[", body), (
                f"{where}: {name}[...] bypasses step_ld")
            assert not re.search(rf"\*\s*\(?\s*{name}\b", body), (
                f"{where}: *{name} bypasses step_ld")


def test_the_row_helpers_load_through_step_ld():
    src = _strip_comments((CSRC / "sgns_common.cuh").read_text())
    for helper in ("load4", "load_batch"):
        bodies = [src[b:_balanced(src, b, "{", "}")] for b in (
            src.index("{", m.end()) for m in re.finditer(
                rf"__forceinline__ \w+ {helper}\(", src))]
        assert bodies, helper
        for body in bodies:
            assert any(f in body for f in ("step_ld(", "load4(",
                                           "load_batch<")), helper
    # step_ld is an ordinary load; nothing in csrc/ asks for the read-only
    # (non-coherent) path by hand
    ld = src[src.index("T step_ld(const T* p)"):]
    assert re.match(r"\s*\{\s*return \*p;\s*\}", ld[len("T step_ld(const "
                                                      "T* p)"):])
    for path in SOURCES:
        assert not re.search(r"__ldg\(|ld\.global\.nc", path.read_text()), \
            path.name


def _functions(src: str):
    """(name, body) of every function defined in ``src`` (comments
    stripped)."""
    out = []
    for m in re.finditer(r"\b(\w+)\s*\(", src):
        p = m.end() - 1
        try:
            q = _balanced(src, p, "(", ")")
        except AssertionError:
            continue
        rest = src[q:q + 200]
        b = re.match(r"\s*(?:const\s*)?\{", rest)
        if b and m.group(1) not in ("if", "for", "while", "switch",
                                    "return", "sizeof"):
            start = q + b.end() - 1
            out.append((m.group(1), src[start:_balanced(src, start, "{",
                                                         "}")]))
    return out


def copy_issuers(sources) -> set:
    """The functions of ``sources`` that issue an asynchronous copy from
    global memory: those whose body holds a ``cp.async`` (any form, bulk
    and TMA's ``cp.async.bulk.tensor`` too), and, to a fixed point, those
    that call one."""
    funcs = [f for s in sources for f in _functions(_strip_comments(s))]
    found = {n for n, body in funcs if "cp.async" in body}
    while True:
        more = {n for n, body in funcs if n not in found and any(
            re.search(rf"\b{c}\s*[<(]", body) for c in found)}
        if not more:
            return found
        found |= more


def copies_before_wait(body: str, issuers) -> list:
    """The asynchronous copies a kernel body issues before its first
    ``pdl_wait()`` whose arguments name a step-written buffer: each as the
    call's text.  Inline ``cp.async`` asm counts as a call too."""
    wait = body.find("pdl_wait()")
    head = body if wait < 0 else body[:wait]
    out = []
    for m in re.finditer(r"\b(asm)\b(?:\s+volatile)?\s*\(|"
                         r"\b(\w+)\s*(?:<[^<>;]*>)?\s*\(", head):
        if m.group(1) is None and m.group(2) not in issuers:
            continue
        q = _balanced(head + ")" * 64, m.end() - 1, "(", ")")
        call = head[m.start():q]
        if m.group(1) and "cp.async" not in call:
            continue
        if any(re.search(rf"\b{n}\b", call) for n in STEP_WRITTEN):
            out.append(call)
    return out


def test_the_copy_check_finds_the_asynchronous_copies():
    issuers = copy_issuers(p.read_text() for p in SOURCES)
    # the wide passes' copies: bulk and cp.async, and the row helper that
    # issues either
    for want in ("bulk_copy", "async_copy4", "async_copy16", "copy_rows"):
        assert want in issuers, want
    bodies = {k.split(":")[1]: body for k, _, body in pdl_kernels()}
    for name in ("negative_f32_wide_kernel", "negative_bf16_wide_kernel",
                 "walk_pos_wide_kernel", "star_pos_wide_kernel"):
        body = bodies[name]
        assert any(re.search(rf"\b{c}\s*[<(]", body) for c in issuers), name
        # ... all of them after the wait (a call is the issuer's whole
        # name: mbar_init( is not a call of an issuer named init)
        wait = body.index("pdl_wait()")
        assert not any(re.search(rf"\b{c}\s*[<(]", body[:wait])
                       for c in issuers), name


@pytest.mark.parametrize("where,params,body", pdl_kernels(),
                         ids=[k for k, _, _ in pdl_kernels()])
def test_pdl_kernels_copy_step_buffers_only_after_the_wait(where, params,
                                                           body):
    issuers = copy_issuers(p.read_text() for p in SOURCES)
    bad = copies_before_wait(body, issuers)
    assert not bad, f"{where}: copies before pdl_wait(): {bad}"


FAKE = """
static __device__ void copy_row(float* dst, const float* src, int n,
                                unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
               "complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(0), "l"(src), "r"(n), "r"(0));
}
static __global__ void early_kernel(const float* cneg, const int* ids,
                                    float* out) {
  __shared__ float buf[256];
  __shared__ unsigned long long bar;
  const int r = step_ld(ids + blockIdx.x);
  copy_row(buf, cneg + (size_t)r * 256, 1024, &bar);
  pdl_wait();
  out[threadIdx.x] = buf[threadIdx.x];
}
static __global__ void inline_kernel(const float* table, float* out) {
  __shared__ float buf[4];
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(0), "l"(table + blockIdx.x));
  pdl_wait();
  out[0] = buf[0];
}
static __global__ void late_kernel(const float* cneg, const int* ids,
                                   float* out) {
  __shared__ float buf[256];
  __shared__ unsigned long long bar;
  const int r = step_ld(ids + blockIdx.x);
  pdl_wait();
  copy_row(buf, cneg + (size_t)r * 256, 1024, &bar);
  out[threadIdx.x] = buf[threadIdx.x];
}
"""


def test_the_copy_check_catches_a_copy_issued_before_the_wait():
    issuers = copy_issuers([FAKE])
    assert "copy_row" in issuers
    found = {name: copies_before_wait(body, issuers)
             for name, _, body in kernels(FAKE)}
    assert len(found["early_kernel"]) == 1
    assert "cneg" in found["early_kernel"][0]
    assert len(found["inline_kernel"]) == 1  # the inline asm's copy
    assert found["late_kernel"] == []

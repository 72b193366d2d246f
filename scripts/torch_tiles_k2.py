"""The tile GEMM (K1's and K5's row-tiled routes, every body of K6) and K2's
plain body timed at the main path's shapes, for one checkout of the
PyTorch/CUDA port (one GPU).

    python scripts/torch_tiles_k2.py [ROOT] [--only PREFIX]

ROOT is the root of the checkout whose ``deepseek_tpu_torch`` is timed
(default: this one); unpack another commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script once for each tree
in one call (parent, change, change, parent) to compare them on one card.
``--only`` keeps the rows whose name starts with PREFIX (e.g. ``K6``).
The tables and activations are drawn on the card from a seed, the same
for every tree, at DeepSeek-V3's widths (dim 7168, 256 routed experts of
4096 x 7168 w13 and 7168 x 2048 w2, the dense w13 36864 x 7168, wkv_b
32768 x 512) and DeepSeek-V2-Lite's (66 experts of 2816 x 2048 w13 and
2048 x 1408 w2, wq 3072 x 2048, wkv_b 4096 x 512):

- K1 row-tiled (Q3_K nibble): the dense w13 at 256 rows, wkv_b at 4096;
- K5 row-tiled: packed Q3_K w13 at 256 rows and wkv_b at 4096, turbo
  Q3_K wkv_b at 4096, F8E5M2 (128x128 blocks) wq at 256 and wkv_b at 4096;
- K6 over a 256-token routing (top 8 of 256, 2048 pairs; nibble: with the
  shared expert as a 257th, 2304): nibble w13s and w2s, nibble w2s with x
  prepermuted, packed Q3_K w13 and w2, turbo Q3_K w13; fp8 over
  V2-Lite's (top 6 of 64 + 2 shared, 2048 pairs) w13s and w2s;
- K2's plain body: V3's bf16 w13s and w2s (16 tables, one token's 9
  pairs) and V2-Lite's f16 w13s and w2s (66 tables, one token's 8 pairs),
  each beside ``torch.bmm`` over the gathered tables with x in the
  table's dtype (f32 accumulation: the same bytes, the activation's
  rounding left out).

For each it prints the kernel's mean device time, its max abs error
against the plain version as a fraction of max|ref| (the live rows), and
the MMA width of the tiles where that varies. Each timed call follows a
512 MB write that evicts the L2 and a device spin, as ``chip_smoke.py``
times. Needs a CUDA GPU; exits 2 without one.
"""

import sys

import torch


def time_ms(fn, flush, iters=20):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tiles_k2: no CUDA GPU visible", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    only = ""
    if "--only" in args:
        i = args.index("--only")
        only = args[i + 1]
        del args[i:i + 2]
    root = args[0] if args else "."
    sys.path.insert(0, root)
    from deepseek_tpu_torch.ops.kernels import build
    from deepseek_tpu_torch.ops.kernels import qmm as Q
    from deepseek_tpu_torch.ops.matmul import tile_dispatch
    from deepseek_tpu_torch.quant.qtensor import (
        Fp8Tensor, KNibbleTensor, PlainTensor, Q3KTensor, perm_x, q3k_to_turbo)

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["qmm", "qmm_tiles"])
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def report(name, fn, plain, select=lambda y: y, library=None, note=""):
        if not name.startswith(only):
            return
        got, want = select(fn()), select(plain())
        err = float((got - want).abs().max()) / float(want.abs().max())
        del got, want
        line = f"{root} {name}: {time_ms(fn, flush):.4f} ms, rel err {err:.2e}"
        if library is not None:
            line += f"; {library[0]} {time_ms(library[1], flush):.4f} ms"
        print(line + note, flush=True)

    def nibble(E, d, n):
        p = torch.randint(0, 256, (E, d, n // 2), generator=g, device=dev, dtype=torch.uint8)
        a = (torch.rand((E, d, n // 16), generator=g, device=dev) * 0.009 + 0.001)
        return KNibbleTensor(p=p, a=a.to(torch.bfloat16), c=None, off=4)

    def packed(E, d, n):
        def u8(cols):
            return torch.randint(0, 256, (E, d, cols), generator=g, device=dev,
                                 dtype=torch.uint8)
        sup = torch.rand((E, d, n // 256), generator=g, device=dev) * 0.009 + 0.001
        sc = torch.randint(-32, 32, (E, d, n // 16), generator=g, device=dev,
                           dtype=torch.int8)
        return Q3KTensor(qs=u8(n // 4), hm=u8(n // 8), d=sup, sc=sc)

    def fp8(E, d, n):
        data = torch.randn((E, d, n), generator=g, device=dev).to(torch.float8_e5m2)
        sc = torch.rand((E, -(-d // 128), -(-n // 128)), generator=g, device=dev) * 0.015 + 0.005
        return Fp8Tensor(data=data, scale=sc, block_size=(128, 128))

    def first(qt):
        return qt.map(lambda t: t[0].contiguous())

    def widths(tr):
        """The tiles' MMA widths (the kernel's choice from the live rows)."""
        w = {}
        for r in tr.tolist():
            if r > 0:
                k = min(b for b in (16, 32, 64, 128) if b >= r)
                w[k] = w.get(k, 0) + 1
        return "; widths " + ", ".join(f"n{k} x{v}" for k, v in sorted(w.items()))

    def rows_entry(name, route, qt, rows):
        d, n = qt.shape
        x = torch.randn((rows, n), generator=g, device=dev)
        report(f"{name} {rows}x{d}x{n}", lambda: route(qt, x), lambda: Q.qmm_plain(qt, x))

    # K1 and K5 row-tiled
    w13 = first(nibble(1, 36864, 7168))
    rows_entry("K1r nibble Q3_K w13", Q.qmm_rows, w13, 256)
    del w13
    wkv = first(nibble(1, 32768, 512))
    rows_entry("K1r nibble Q3_K wkv_b", Q.qmm_rows, wkv, 4096)
    del wkv
    w13 = first(packed(1, 36864, 7168))
    rows_entry("K5r packed Q3_K w13", Q.qmm_packed_rows, w13, 256)
    del w13
    wkv = first(packed(1, 32768, 512))
    rows_entry("K5r packed Q3_K wkv_b", Q.qmm_packed_rows, wkv, 4096)
    rows_entry("K5r turbo Q3_K wkv_b", Q.qmm_turbo_rows, q3k_to_turbo(wkv), 4096)
    del wkv
    rows_entry("K5r fp8 wq", Q.qmm_fp8_rows, first(fp8(1, 3072, 2048)), 256)
    rows_entry("K5r fp8 wkv_b", Q.qmm_fp8_rows, first(fp8(1, 4096, 512)), 4096)

    # K6: V3's routed tables under a 256-token top-8 routing
    T, E = 256, 256
    routed = torch.rand((T, E), generator=g, device=dev).topk(8, dim=-1).indices

    def k6(name, qt, idx, n_tab, xperm=False):
        te, tr, _, G = tile_dispatch(idx.reshape(-1), n_tab)
        live = torch.arange(128, device=dev)[None, :] < tr[:, None]
        _, d, n = qt.shape
        x = torch.randn((G, 128, n), generator=g, device=dev)
        if xperm:
            x = perm_x(x).contiguous()
        report(f"{name} {G} tiles, {int(tr.sum())} pairs, {d}x{n}",
               lambda: Q.qmm_grouped(qt, te, x, tr, x_prepermuted=xperm),
               lambda: Q.qmm_grouped_plain(qt, te, x, tr, x_prepermuted=xperm),
               select=lambda y: y[live], note=widths(tr))

    shared = torch.cat([routed, torch.full((T, 1), E, device=dev)], -1)
    qt = nibble(E + 1, 4096, 7168)
    k6("K6 nibble Q3_K w13s", qt, shared, E + 1)
    del qt
    qt = nibble(E + 1, 7168, 2048)
    k6("K6 nibble Q3_K w2s", qt, shared, E + 1)
    k6("K6-xperm nibble Q3_K w2s", qt, routed, E + 1, xperm=True)
    del qt
    qt = packed(E, 4096, 7168)
    k6("K6 packed Q3_K w13", qt, routed, E)
    turbo = q3k_to_turbo(qt)
    del qt
    k6("K6 turbo Q3_K w13", turbo, routed, E)
    del turbo
    qt = packed(E, 7168, 2048)
    k6("K6 packed Q3_K w2", qt, routed, E)
    del qt
    # V2-Lite's fp8 tables: top 6 of 64 routed + 2 shared a token
    r2 = torch.rand((T, 64), generator=g, device=dev).topk(6, dim=-1).indices
    idx2 = torch.cat([r2, torch.arange(64, 66, device=dev).expand(T, 2)], -1)
    for label, d, n in (("w13s", 2816, 2048), ("w2s", 2048, 1408)):
        qt = fp8(66, d, n)
        k6(f"K6-fp8 {label}", qt, idx2, 66)
        del qt

    # K2's plain body, beside torch.bmm over the gathered tables
    for label, E2, d, n, pairs, dt in (("V3 bf16 w13s", 16, 4096, 7168, 9, torch.bfloat16),
                                       ("V3 bf16 w2s", 16, 7168, 2048, 9, torch.bfloat16),
                                       ("V2-Lite f16 w13s", 66, 2816, 2048, 8, torch.float16),
                                       ("V2-Lite f16 w2s", 66, 2048, 1408, 8, torch.float16)):
        qt = PlainTensor(data=(torch.randn((E2, d, n), generator=g, device=dev) * 0.02).to(dt))
        idx = torch.randperm(E2, generator=g, device=dev)[:pairs].sort().values
        x = torch.randn((pairs, n), generator=g, device=dev)
        wsel, xl = qt.data[idx], x.to(dt)[:, :, None]
        report(f"K2f {label} {pairs}x{d}x{n}", lambda: Q.qmm_experts(qt, idx, x),
               lambda: Q.qmm_experts_plain(qt, idx, x),
               library=("torch.bmm", lambda: torch.bmm(wsel, xl)))
        del qt, wsel
    return 0


if __name__ == "__main__":
    sys.exit(main())

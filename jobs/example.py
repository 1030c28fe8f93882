"""Production example job (the reference's jobs/example.jl equivalent):
run any scheme by name at a chosen resolution. Leaves PVD + data.csv
artifacts behind when --out is given."""
import argparse

SCHEMES = {
    "wcsph": "wcsph_perturbed_witch",
    "hopkins": "hopkins_perturbed_witch",
    "full_hopkins": "full_hopkins_perturbed_witch",
    "hopkins_total": "hopkins_total_witch",
    "pavelka": "pavelka_total_witch",
    "isph": "isph_witch",
    "rayleigh_benard": "rayleigh_benard",
    "witch3d": "witch3d",
    # legacy family (src/legacy/*.jl), incl. BASELINE config #3's terrain
    "isothermal_static": "legacy_witch",
    "isothermal_flow": "legacy_witch",
    "adiabatic_static": "legacy_witch",
    "adiabatic_flow": "legacy_witch",
    "terrain": "legacy_witch",
}

LEGACY_FACTORIES = {
    "isothermal_static": "isothermal_static_config",
    "isothermal_flow": "isothermal_flow_config",
    "adiabatic_static": "adiabatic_static_config",
    "adiabatic_flow": "adiabatic_flow_config",
    "terrain": "terrain_baseline_config",
}

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("scheme", choices=SCHEMES, nargs="?", default="wcsph")
    ap.add_argument("--rows", type=int, default=75)
    ap.add_argument("--t-end", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import importlib
    mod = importlib.import_module(
        f"sph_mountain_waves_tpu.models.{SCHEMES[args.scheme]}")
    if args.scheme == "pavelka":
        from sph_mountain_waves_tpu.models.pavelka_total_witch import PavelkaConfig
        cfg = PavelkaConfig(n_rows=args.rows, t_end=args.t_end, dtype="float32")
    elif args.scheme == "isph":
        from sph_mountain_waves_tpu.models.isph_witch import ISPHWitchConfig
        cfg = ISPHWitchConfig(n_rows=args.rows, t_end=args.t_end,
                              dtype="float32")
    elif args.scheme == "rayleigh_benard":
        from sph_mountain_waves_tpu.models.rayleigh_benard import Config
        cfg = Config(n_rows=args.rows, t_end=args.t_end, dtype="float32")
    elif args.scheme == "witch3d":
        from sph_mountain_waves_tpu.models.witch3d import stretch_config
        cfg = stretch_config(n_rows=args.rows, t_end=args.t_end)
    elif args.scheme in LEGACY_FACTORIES:
        from sph_mountain_waves_tpu.models import legacy_witch as lw
        factory = getattr(lw, LEGACY_FACTORIES[args.scheme])
        kw = dict(t_end=args.t_end, dtype="float32", use_pallas=True)
        if args.scheme != "terrain":   # terrain fixes its own resolution
            kw["n_rows"] = args.rows
        cfg = factory(**kw)
    else:
        from sph_mountain_waves_tpu.models.witch_common import WitchConfig
        # production layout: skin 0.15 keeps hex-lattice bucket occupancy
        # <= 6 -> cap 8 (skin 0.2 tips occupancy to 8 -> cap 16, ~2x the
        # pair-sweep work); lattice-aligned cells keep occupancy uniform
        cfg = WitchConfig(n_rows=args.rows, t_end=args.t_end, dtype="float32",
                          self_density=True, layout="bucket", skin=0.15,
                          lattice_cells=True, lazy_diagnostics=True,
                          use_pallas=True)
    out = mod.run(cfg, out_path=args.out, verbose=True)
    key = "u_max" if "u_max" in out else "KE"
    print(f"done; final {key} =", out[key][-1])

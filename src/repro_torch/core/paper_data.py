"""Published numbers from the paper's tables — used for calibration targets
and side-by-side comparison in benchmarks (never as our own results).

Table I  — one-shot kernels (1024 total input elements).
Table II — multi-shot kernels (sizes in Sec. VII-B).
Table IV — state-of-the-art comparison points.
Hardware: TSMC 65 nm LP, 250 MHz, 4x4 CGRA, 8x32 KB banks (4 interleaved).
"""

CLOCK_MHZ = 250.0

TABLE_I = {
    # kernel: (config_cycles, exec_cycles, n_ops, outputs_per_cycle,
    #          perf_mops, cgra_mw, eff_mops_mw, cpu_cycles, cpu_mw,
    #          speedup, esave_cpu, soc_cgra_mw, soc_cpu_mw, esave_soc)
    "fft":      (84, 523, 2560, 1.95, 1223.71, 16.84, 72.68, 9218, 4.04,
                 17.63, 4.23, 53.84, 27.59, 9.03),
    "relu":     (74, 697, 2048, 1.47, 734.58, 11.51, 63.80, 10759, 3.44,
                 15.44, 4.62, 45.34, 26.59, 9.05),
    "dither":   (74, 4617, 5120, 0.222, 277.24, 9.01, 30.76, 14342, 3.54,
                 3.11, 1.22, 28.84, 26.09, 2.81),
    "find2min": (84, 7175, 9216, 5.57e-4, 321.11, 9.64, 33.31, 14381, 3.37,
                 2.00, 0.70, 28.84, 26.59, 1.85),
}

TABLE_II = {
    # kernel: (total_cycles, n_ops, outputs_per_cycle, perf_mops, cgra_mw,
    #          eff_mops_mw, cpu_cycles, cpu_mw, speedup, esave_cpu,
    #          soc_cgra_mw, soc_cpu_mw, esave_soc)
    "mm16":    (12105, 7936, 2.11e-2, 163.90, 3.99, 41.08, 42181, 3.59,
                3.48, 3.14, 28.34, 27.34, 3.36),
    "mm64":    (297050, 520192, 1.38e-2, 437.80, 7.46, 58.66, 3965254, 3.59,
                13.35, 6.43, 33.84, 27.34, 10.79),
    "conv2d":  (13931, 65348, 2.58e-1, 1172.71, 10.11, 115.96, 259234, 4.09,
                18.61, 7.53, 47.09, 28.09, 11.10),
    "gemm":    (320284, 681000, 1.31e-2, 531.56, 9.91, 53.62, 3438372, 3.54,
                10.74, 3.84, 38.09, 26.59, 7.49),
    "gemver":  (39825, 144120, 3.68e-1, 904.71, 10.36, 87.30, 522364, 3.74,
                13.12, 4.74, 40.34, 27.59, 8.97),
    "gesummv": (12091, 32670, 7.44e-3, 675.50, 8.99, 75.16, 111080, 3.67,
                9.19, 3.75, 38.09, 28.34, 6.84),
    "2mm":     (347446, 603200, 9.21e-3, 434.02, 8.66, 50.10, 3370417, 3.74,
                9.70, 4.19, 36.34, 27.59, 7.37),
    "3mm":     (579309, 1071700, 4.83e-3, 462.49, 8.29, 55.80, 5390990, 3.72,
                9.31, 4.18, 35.84, 27.84, 7.23),
}

# PolyBench 4.2.1 SMALL_DATASET problem sizes (Sec. VI-B)
POLYBENCH_SMALL = {
    "gemm":    {"NI": 60, "NJ": 70, "NK": 80},
    "gemver":  {"N": 120},
    "gesummv": {"N": 90},
    "2mm":     {"NI": 40, "NJ": 50, "NK": 70, "NL": 80},
    "3mm":     {"NI": 40, "NJ": 50, "NK": 60, "NL": 70, "NM": 80},
}

TABLE_IV = {
    # work: {bench: (perf_mops, power_mw, eff)} — post-synthesis except UE-CGRA
    "IPA":      {"mm16": (65.98, 0.49, 134.65)},
    "UE-CGRA":  {"fft": (625.00, 14.01, 44.61)},
    "RipTide":  {"fft": (62.0, 0.24, 258.33)},   # RipTide fft at 50 MHz
    "STRELA":   {"fft": (1223.71, 16.84, 72.68),
                 "mm16": (163.90, 3.99, 41.08),
                 "mm64": (437.80, 7.46, 58.66)},
}

# Area results (Sec. VII-A), for the comparison table
AREA = {
    "pe_um2": 13936.0,
    "cgra_um2": 253442.0,
    "soc_mm2": 2.38,
}

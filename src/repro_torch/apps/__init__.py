"""Applications from the paper's evaluation (§6), implemented on the
framework: Big-Data apps (Minebench, TeraSort, K-Means, PageRank,
Transitive Closure) and HPC proxy apps (stencil = LULESH/miniAMR analogue,
CG solver = AMG analogue) run as native SPMD programs via worker.call.
"""

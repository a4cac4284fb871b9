"""Hand-written CUDA kernels of the port, each beside its plain twin.

    segment_reduce  (A)  csrc/segment_reduce.cu
    hvp_bucket      (B)  csrc/hvp_bucket.cu
    pd_project      (C)  csrc/pd_project.cu
    pd_project_z    (Z)  csrc/pd_project.cu (converged mode, wide layout)
    block3_inverse,
    block3_apply    (D)  csrc/block3.cu
    tables          (AA) csrc/gather_tables.cu
    hvp_table       (AB) csrc/hvp_table.cu
    dense_runs      (AC) csrc/dense_runs.cu

A wrapper takes its twin only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. `build.launches` counts the launches.
"""

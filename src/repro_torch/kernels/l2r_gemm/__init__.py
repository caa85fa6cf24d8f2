"""The L2R digit-plane GEMM: kernel B1, its plain version and ops."""

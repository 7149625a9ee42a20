"""Host-side native helpers of the port (not card kernels)."""

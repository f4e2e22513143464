from tiktoken_tpu_torch.utils.profiling import Throughput, device_trace, engine_report

__all__ = ["Throughput", "device_trace", "engine_report"]

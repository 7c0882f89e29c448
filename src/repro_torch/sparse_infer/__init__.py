from repro_torch.sparse_infer.compress import (
    CompressedTensor,
    compress_params,
    compression_report,
    decompress_params,
    export_compressed,
)

"""File scans of the port."""
from spark_rapids_tpu_torch.io.scan import (CsvScanExec,  # noqa: F401
                                            FileScanExec, ParquetScanExec)

from cvd_tpu_torch.pipelines.common import PipelineModules
from cvd_tpu_torch.pipelines.simple import SimplePipeline

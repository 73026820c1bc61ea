from cvd_tpu_torch.schedulers.ddim import DDIMScheduler, DDIMState

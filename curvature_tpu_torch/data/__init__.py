from curvature_tpu_torch.data.synthetic import synthetic_images

__all__ = ["synthetic_images"]

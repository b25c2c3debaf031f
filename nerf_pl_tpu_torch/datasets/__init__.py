"""Datasets: the port's own copies of the JAX package's numpy dataset classes
(blender, llff and their ray, pose and depth utilities; PIL only where an
image is read) and camera rays in torch (`rays`)."""
from .blender import BlenderDataset
from .llff import LLFF360Dataset, LLFFDataset

dataset_dict = {"blender": BlenderDataset, "llff": LLFFDataset}

__all__ = ["BlenderDataset", "LLFF360Dataset", "LLFFDataset",
           "dataset_dict"]

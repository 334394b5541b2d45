from setuptools import find_packages, setup

setup(
    name="holocron-tpu",
    version="0.1.0.dev0",
    description="TPU-native computer-vision framework in JAX with the capabilities of frgfm/Holocron",
    packages=find_packages(include=["holocron_tpu", "holocron_tpu.*", "holocron_tpu_torch", "holocron_tpu_torch.*"]),
    package_data={"holocron_tpu.models": ["_data/*.json"], "holocron_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
)

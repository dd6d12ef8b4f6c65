# Build run.cu into the port's build directory and run it on the card:
#   bash scripts/warp_product_copies/run.sh
set -e
here="$(cd "$(dirname "$0")" && pwd)"
build="$here/../../spartan_tpu_torch/build"
mkdir -p "$build"
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
  -I"$here/../../spartan_tpu_torch/csrc" "$here/run.cu" -o "$build/warp_product_copies"
"$build/warp_product_copies"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

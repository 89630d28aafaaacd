#!/usr/bin/env bash
# The pod's serving program at SERVE_TP=1, 2 and 4 on a host with four
# cards (a whole-card grant's env, strict mode: no engine fallback), its
# bench config (int8 weights and pages, 32 slots x 1024 x 128, 32
# requests); prints the card and each run's main lines.
#
#     bash experiments/torch_pod_tp.sh      # from the repository root
set -e
python -c "from kubegpu_tpu_torch import kernels; kernels.build()" > /dev/null
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tp in 1 2 4; do
  echo "== SERVE_TP=$tp"
  env KUBETPU_HBM_GIB=80 TPU_WORKER_ID=0 KUBETPU_REQUIRE_PALLAS=1 \
    SERVE_MODE=continuous SERVE_REQS=32 SERVE_TP=$tp \
    python -m kubegpu_tpu_torch.workloads.programs.llama_serve \
    | grep -E 'serve_engine_tokens_per_s|serve_engine_cfg_tp"|mesh_devices|serve_engine_ticks|serve_engine_waves|phase_drain|serve_hbm_pool|serve_engine_occupancy|serve_kv_bits'
done

#!/usr/bin/env bash
# The round-5 flagship recipe (docs/runs/r5_flagship/README.md, "Reproduce")
# through the port's CLIs at the r5 scale, on one CUDA card:
#
#   bash docs/runs/r5_flagship_torch/run.sh [WORK [OUT [STAGES]]]
#
# WORK    work dir outside the tree (default ${TMPDIR:-/tmp}/r5_flagship_torch):
#         the dataset (about 16 GB of npz files), the labels, the checkpoints
# OUT     where the small artifacts go (default build/r5_flagship_torch)
# STAGES  the stages to run, in this order (default "1 2 4 3 5 6"):
#         1 generate, 2 mine labels, 3 train the policy, 4 train the detector,
#         5 score 1000 chains, 6 score 1000 chains with held-out paraphrases;
#         p, not part of the recipe: the evaluator's rate at the protocol's
#         shape (1000 chains, 32 envs in 4 cohorts, hierarchical) with random
#         weights, from its partial results when BUDGET_S cuts it
#
# BUDGET_S (environment, optional): seconds the whole script may take. A stage
# runs under what is left of it, and a stage that is cut is written down as
# such in stage_timings.jsonl. Stage 1 and 2 end the script when their counts
# differ from the r5 run's (263,393 frames, 10,065 language windows, 22,843
# labels): every later stage would then train on other data.
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/r5_flagship_torch}
OUT=${2:-build/r5_flagship_torch}
STAGES=${3:-1 2 4 3 5 6}
DATA=$WORK/calvin_expert_r5
AFF_DATA=$WORK/calvin_expert_r5_aff
HERE=$(cd "$(dirname "$0")" && pwd)
T_START=$(date +%s)
DEADLINE=$(( T_START + ${BUDGET_S:-1000000000} ))

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$WORK" "$OUT/logs"
OUT=$(cd "$OUT" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)" > "$OUT/versions.txt"
df -h "$WORK" | tee "$OUT/disk.txt"
export HULC2_SEQUENCES_CACHE_DIR=$WORK/cache  # one chain cache for both protocols
mkdir -p "$HULC2_SEQUENCES_CACHE_DIR"

# every 15 s: the card's utilisation, memory and power, the host's used RAM,
# and the evaluator's partial results (kept if a protocol is cut)
monitor() {
    echo "time_s,gpu_util_pct,gpu_mem_mib,gpu_power_w,host_used_mib" > "$OUT/monitor.csv"
    while true; do
        local g h
        g=$(nvidia-smi --query-gpu=utilization.gpu,memory.used,power.draw \
            --format=csv,noheader,nounits | head -n1 | tr -d ' ')
        h=$(awk '/MemTotal/ {t=$2} /MemAvailable/ {a=$2} END {print int((t-a)/1024)}' /proc/meminfo)
        echo "$(date +%s),$g,$h" >> "$OUT/monitor.csv"
        for d in eval_1000 eval_1000_paraphrase eval_random; do
            [ -f "$WORK/$d/partial_results.json" ] && cp "$WORK/$d/partial_results.json" "$OUT/$d.partial_results.json"
        done
        sleep 15
    done
}
monitor &
MONITOR=$!
trap 'kill $MONITOR 2>/dev/null || true' EXIT

# stage N NAME CMD...: runs CMD under the time left, its log in logs/, its
# start, end and exit code in stage_timings.jsonl
stage() {
    local n=$1 name=$2 t0 t1 rc left
    shift 2
    left=$(( DEADLINE - $(date +%s) ))
    t0=$(date +%s.%N)
    echo "== stage $n $name start $(date -u +%FT%TZ)"
    if [ "$left" -le 0 ]; then
        rc=124
    else
        set +e
        timeout -k 30 "$left" "$@" > "$OUT/logs/stage$n-$name.log" 2>&1
        rc=$?
        set -e
    fi
    t1=$(date +%s.%N)
    echo "== stage $n $name end $(date -u +%FT%TZ) rc=$rc"
    echo "{\"stage\": \"$n\", \"name\": \"$name\", \"start\": $t0, \"end\": $t1, \"seconds\": $(python -c "print($t1 - $t0)"), \"rc\": $rc, \"cut\": $([ $rc -eq 124 ] && echo true || echo false)}" >> "$OUT/stage_timings.jsonl"
    tail -n 5 "$OUT/logs/stage$n-$name.log" 2>/dev/null || true
    return $rc
}

collect() {  # copy a file if it is there
    [ -f "$1" ] && cp "$1" "$2" || true
}

for s in $STAGES; do
    case $s in
    1)
        stage 1 generate python -m hulc2_torch.tools.make_expert_dataset "$DATA" \
            --episodes 200 --tasks-per-episode 24 --val-episodes 8 \
            --val-tasks-per-episode 12 --lang-tokens --holdout-paraphrases 4 --seed 0 \
            --unaligned-lang-windows
        du -sh "$DATA" >> "$OUT/disk.txt"
        python "$HERE/report.py" dataset "$DATA" | tee "$OUT/dataset_counts.json"
        ;;
    2)
        stage 2 mine python -m hulc2_torch.affordance.dataset_creation "$DATA" \
            --out-dir "$AFF_DATA" --holdout-paraphrases 4
        python "$HERE/report.py" labels "$AFF_DATA" | tee "$OUT/label_counts.json"
        ;;
    3)
        rc=0
        stage 3 policy python -m hulc2_torch.training --run-dir "$WORK/policy" --max-epochs 8 \
            datamodule.root_data_dir="$DATA" datamodule.device_store=true \
            datamodule.transforms=rand_shift_96 datamodule.load_lang_embeddings=false \
            model/language_encoder=clip_scratch model.use_lang_task_auxiliary_loss=true \
            trainer.limit_val_batches=6 || rc=$?
        collect "$WORK/policy/config.json" "$OUT/policy_config.json"
        collect "$WORK/policy/metrics.jsonl" "$OUT/policy_metrics.jsonl"
        [ $rc -eq 0 ] || exit $rc
        ;;
    4)
        rc=0
        stage 4 detector python -m hulc2_torch.affordance.train_affordance --run-dir "$WORK/aff" \
            --max-epochs 15 aff_detection=rn18_tokens_pixel \
            aff_detection.dataset.data_dir="$AFF_DATA" || rc=$?
        collect "$WORK/aff/config.json" "$OUT/aff_config.json"
        collect "$WORK/aff/metrics.jsonl" "$OUT/aff_metrics.jsonl"
        [ $rc -eq 0 ] || exit $rc
        ;;
    5|6)
        name=eval_1000
        extra=()
        if [ "$s" = 6 ]; then name=eval_1000_paraphrase; extra=(--paraphrase-eval); fi
        rc=0
        stage "$s" "$name" python -m hulc2_torch.evaluation.evaluate_policy \
            --train-dir "$WORK/policy" --fake-env --device-render --n-envs 32 --cohorts 4 \
            --num-sequences 1000 --ep-len 360 --aff-train-dir "$WORK/aff" \
            --log-dir "$WORK/$name" "${extra[@]}" || rc=$?
        mkdir -p "$OUT/$name"
        collect "$WORK/$name/results.json" "$OUT/$name/results.json"
        collect "$WORK/$name/eval_diagnostics.json" "$OUT/$name/eval_diagnostics.json"
        collect "$WORK/$name/partial_results.json" "$OUT/$name.partial_results.json"
        [ $rc -eq 0 ] || exit $rc
        ;;
    p)
        stage p detector_random python -m hulc2_torch.affordance.train_affordance --synthetic \
            --max-steps 1 --run-dir "$WORK/aff_random"
        rc=0
        stage p eval_random python -m hulc2_torch.evaluation.evaluate_policy --synthetic \
            --fake-env --device-render --n-envs 32 --cohorts 4 --num-sequences 1000 \
            --ep-len 360 --aff-train-dir "$WORK/aff_random" --log-dir "$WORK/eval_random" || rc=$?
        collect "$WORK/eval_random/partial_results.json" "$OUT/eval_random.partial_results.json"
        [ $rc -eq 0 ] || [ $rc -eq 124 ] || exit $rc
        ;;
    *)
        echo "unknown stage $s" >&2
        exit 2
        ;;
    esac
done
du -sh "$WORK"/* >> "$OUT/disk.txt" 2>/dev/null || true
echo "r5 run done in $(( $(date +%s) - T_START )) s"

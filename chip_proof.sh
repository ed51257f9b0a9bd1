#!/usr/bin/env bash
# The proof run of a tree on one H100: the card tests, the CPD entry point
# on synthetic CATH chains (64 / 16 / 8 chains, 2 epochs, then the test
# chains' design metrics at 20 samples), the EQ entry point on synthetic
# decoys (16 / 4 / 4 decoys of 100-300 residues, 2 epochs), the AR entry
# point on synthetic pairs (16 / 4 / 4 pairs, 2 epochs) and the AR
# prediction entry point on their test decoys with the best checkpoint,
# then every phase of chip_smoke.py.
# Run it from the root of a checkout, for example a `git archive` of the
# commit unpacked into a git-ignored directory:
#
#     bash chip_proof.sh OUT_DIR
#
# OUT_DIR receives chip_smoke.py's report (chip_smoke.json), its standard
# output and errors.  Exits with the first non-zero code of the six.
set -u
out=${1:?usage: bash chip_proof.sh OUT_DIR}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
git rev-parse HEAD 2>/dev/null || echo "tree: not a git checkout"

python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q > "$out/card_tests.txt" 2>&1
tests_rc=$?
tail -3 "$out/card_tests.txt"

data=$(mktemp -d)
python -c "from gcpnet_torch.data.cath_synthetic import write_cath_chains
print(write_cath_chains('$data', chains={'train': 64, 'validation': 16, 'test': 8}))"
python -m gcpnet_torch.train --task cpd --data-dir "$data" --max-epochs 2 --min-epochs 0 --num-samples 20 \
    > "$out/task_cpd.txt" 2>&1
cpd_rc=$?
tail -4 "$out/task_cpd.txt" | cut -c1-600
rm -rf "$data"

data=$(mktemp -d)
python -c "from gcpnet_torch.data.eq_synthetic import write_eq_decoys
print(write_eq_decoys('$data', targets={'train': 4, 'valid': 1, 'test': 1}, decoys=4, residues=(100, 300)))"
python -m gcpnet_torch.train --task eq --data-dir "$data" --max-epochs 2 --min-epochs 0 > "$out/task_eq.txt" 2>&1
eq_rc=$?
tail -3 "$out/task_eq.txt" | cut -c1-600
rm -rf "$data"

data=$(mktemp -d)
python -c "from gcpnet_torch.data.ar_synthetic import write_ar_pairs
print(write_ar_pairs('$data', pairs={'train': 16, 'valid': 4, 'test': 4}))"
python -m gcpnet_torch.train --task ar --data-dir "$data" --max-epochs 2 --min-epochs 0 --checkpoint-dir "$data/ckpt" \
    > "$out/task_ar.txt" 2>&1
ar_rc=$?
tail -3 "$out/task_ar.txt" | cut -c1-600
mkdir -p "$data/test_in"
for name in $(cat "$data/splits/test_ar.lst"); do cp "$data/AF2_model/$name.pdb" "$data/test_in/"; done
python -m gcpnet_torch.predict_ar --input-dir "$data/test_in" --true-dir "$data/true_model" \
    --output-dir "$out/ar_refined" --checkpoint-dir "$data/ckpt" --esm-cache-dir "$data/model_data_cache/esm" \
    > "$out/predict_ar.txt" 2>&1
predict_rc=$?
tail -2 "$out/predict_ar.txt" | cut -c1-600
rm -rf "$data" "$out/ar_refined"

python3 chip_smoke.py --out-dir "$out" > "$out/stdout.txt" 2> "$out/stderr.txt"
smoke_rc=$?
grep -hE "^phase [a-z0-9-]+: ok|FAILED|every phase" "$out/stdout.txt" "$out/stderr.txt" | cut -c1-300
tail -3 "$out/stdout.txt" | cut -c1-6000

echo "card tests rc=$tests_rc, --task cpd rc=$cpd_rc, --task eq rc=$eq_rc, --task ar rc=$ar_rc," \
    "predict_ar rc=$predict_rc, chip_smoke rc=$smoke_rc"
for rc in $tests_rc $cpd_rc $eq_rc $ar_rc $predict_rc $smoke_rc; do
    [ "$rc" -ne 0 ] && exit "$rc"
done
exit 0
